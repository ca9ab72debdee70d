"""The port's spans and counters (``calciumgan_tpu_torch.utils.tracing``) on
the CPU: the span names of a served batch and of a WGAN-GP step with their
nesting and ids, the counters they feed, ``deconvolve_file``'s report, and
the reading of a profile: device work without the annotations that mirror
spans, and the device seconds under each span."""

import collections
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch.algorithms import get_algorithm
from calciumgan_tpu_torch.algorithms.gan import Draws
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data import pipeline
from calciumgan_tpu_torch.eval import spike_eval
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.ops import oasis
from calciumgan_tpu_torch.parallel import mesh
from calciumgan_tpu_torch.utils import h5, tracing

torch.set_num_threads(1)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
T, C, BATCH = 64, 6, 8


def tiny_config(**kw) -> Config:
    d = dict(model="calciumgan", algorithm="wgan-gp", sequence_length=T,
             num_neurons=C, num_channels=C, signal_shape=(T, C),
             noise_dim=8, num_units=4, kernel_size=4, strides=2, m=2,
             batch_size=BATCH, n_critic=2, normalize=True, layer_norm=True,
             signals_min=0.0, signals_max=1.0, learning_rate=1e-5,
             verbose=0)
    d.update(kw)
    return Config(**d)


@pytest.fixture
def flag_every_trace(monkeypatch):
    """A borderline band wide enough that every trace is flagged, so the
    float64 redo runs."""
    monkeypatch.setattr(oasis, "_BORDERLINE_TOL", 1.0)


def served(batches: int = 2):
    """A tiny generator's ``generate(..., with_spikes=True)``, not yet
    started."""
    config = tiny_config()
    generator, _ = get_models(config)
    variables = convert.flax_generator_variables(generator.state_dict())
    return generate_mod.generate(config, variables, BATCH * batches,
                                 BATCH, with_spikes=True, seed=3,
                                 device="cpu")


def profiled(fn) -> list:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.events())


def spans(events) -> list:
    return [e for e in events if e.name.startswith(tracing.PREFIX)]


def parents(event) -> list:
    out, op = [], event.cpu_parent
    while op is not None:
        out.append(op.name)
        op = op.cpu_parent
    return out


def names(*short) -> set:
    return {tracing.PREFIX + s for s in short}


def test_a_served_batch_nests_its_spans(flag_every_trace):
    events = profiled(lambda: list(served()))
    found = spans(events)
    batch = tracing.PREFIX + "generate/batch"
    assert sum(e.name == batch for e in found) == 2
    assert {e.name for e in found} == names(
        "generate/batch", "generate/forward", "generate/signals_to_host",
        "oasis/kernel", "oasis/redo", "oasis/spikes_to_host")
    for e in found:
        if e.name != batch:
            assert batch in parents(e), e.name
    assert all(parents(e) == [] for e in found if e.name == batch)


def test_a_train_step_nests_its_spans():
    config = tiny_config()
    algo = get_algorithm(config, *get_models(config))
    state = algo.init_state()
    real = torch.from_numpy(np.random.default_rng(0).random(
        (BATCH, T, C)).astype(np.float32))
    events = profiled(lambda: algo.train_step(state, real,
                                              Draws(1, 0, "cpu")))
    found = collections.Counter(e.name for e in spans(events))
    assert found == {tracing.PREFIX + n: k for n, k in (
        ("step", 1), ("step/critic", 2), ("step/penalty", 2),
        ("step/generator", 1), ("step/update", 3), ("step/ema", 1),
        ("step/metrics", 1))}
    step = tracing.PREFIX + "step"
    for e in spans(events):
        if e.name != step:
            assert step in parents(e), e.name
        if e.name.endswith("step/penalty"):
            assert parents(e)[0] == tracing.PREFIX + "step/critic"


def test_spans_carry_their_ids(monkeypatch, flag_every_trace):
    opened = []
    record = torch.profiler.record_function

    def recorded(name, args=None):
        opened.append((name, args))
        return record(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recorded)
    profiled(lambda: list(served()))
    config = tiny_config()
    algo = get_algorithm(config, *get_models(config))
    state = algo.init_state()
    real = torch.rand(BATCH, T, C, generator=torch.Generator().manual_seed(0))
    for k in range(2):
        profiled(lambda: algo.train_step(state, real, Draws(1, k, "cpu")))
    by_name = collections.defaultdict(list)
    for name, args in opened:
        by_name[name[len(tracing.PREFIX):]].append(args)
    assert by_name["generate/batch"] == ["batch=0", "batch=1"]
    assert by_name["oasis/kernel"] == ["depth=64", "depth=64"]
    assert by_name["oasis/redo"] == [f"rows={BATCH * C}"] * 2
    assert by_name["step"] == ["step=0", "step=1"]
    assert by_name["generate/forward"] == [None, None]


def test_serving_counts_its_traces_and_flags(flag_every_trace):
    before, calls = collections.Counter(tracing.totals), collections.Counter(
        tracing.calls)
    payloads = list(served(3))
    totals = tracing.totals - before
    assert totals["oasis/traces"] == 3 * BATCH * C
    assert 0 < totals["oasis/flagged"] <= totals["oasis/traces"]
    assert (tracing.calls - calls)["generate/batch"] == 3
    assert totals["oasis/redo"] > 0
    children = sum(totals[n] for n in (
        "generate/forward", "generate/signals_to_host", "oasis/kernel",
        "oasis/redo", "oasis/spikes_to_host"))
    assert children <= totals["generate/batch"]
    assert all(p["spikes"].shape == (BATCH, T, C) for p in payloads)


def test_no_span_stays_open_across_the_yield():
    batches = served(2)
    calls = tracing.calls["generate/batch"]
    seen = []

    def consume():
        next(batches)
        seen.append(tracing.calls["generate/batch"] - calls)
        with torch.profiler.record_function("consumer"):
            torch.ones(3).sum()  # the consumer's own work
        next(batches)

    events = profiled(consume)
    assert seen == [1]  # the first batch's span closed before its yield
    mine, = [e for e in events if e.name == "consumer"]
    assert not [n for n in parents(mine) if n.startswith(tracing.PREFIX)]


def test_deconvolve_file_reports_its_keys(tmp_path, flag_every_trace):
    path = str(tmp_path / f"epoch{h5.default_suffix()}")
    signals = np.random.default_rng(5).random((4, T, C)).astype(np.float32)
    h5.write(path, {"signals": signals})
    report = spike_eval.deconvolve_file(tiny_config(), path, device="cpu")
    assert set(report) == {"read", "upload", "deconvolve", "write", "total",
                           "kernel", "spikes_to_host", "redo", "traces",
                           "flagged", "bit0", "bit1", "bit2",
                           "window_moves"}
    assert report["traces"] == 4 * C
    assert report["window_moves"] == 0  # the plain version's whole rings
    assert report["flagged"] <= report["traces"]
    assert report["kernel"] + report["redo"] <= report["deconvolve"]


def test_deconvolve_file_reports_the_change_of_the_totals(tmp_path):
    path = str(tmp_path / f"epoch{h5.default_suffix()}")
    trials = 3
    signals = np.random.default_rng(6).random((trials, T, C)).astype(
        np.float32)
    h5.write(path, {"signals": signals})
    # a dispatch before the call
    oasis.deconvolve_signals_host(signals[:1].transpose(0, 2, 1))
    calls = collections.Counter(tracing.calls)
    before = collections.Counter(tracing.totals)
    report = spike_eval.deconvolve_file(tiny_config(), path, device="cpu")
    grew = {name[len("oasis/"):]: tracing.totals[name] - before[name]
            for name in tracing.calls - calls if name.startswith("oasis/")}
    stages = {"read", "upload", "deconvolve", "write", "total"}
    assert {k: v for k, v in report.items() if k not in stages} == grew
    # counts of 0 too (no trace of T frames overflows a depth of T)
    assert {"kernel", "spikes_to_host", "traces", "flagged", "bit0", "bit1",
            "bit2"} <= set(grew) and report["bit0"] == 0
    assert report["traces"] == trials * C < tracing.totals["oasis/traces"]
    assert report["kernel"] <= report["deconvolve"]


def test_the_loop_and_the_collective_spans():
    calls = collections.Counter(tracing.calls)
    store = pipeline.DeviceStore(np.zeros((4, T, C), np.float32), "cpu")
    store.batch(np.array([0, 2]))
    host = pipeline.HostBatches(np.zeros((4, T, C), np.float32), "cpu")
    assert len(list(pipeline.DevicePrefetcher(
        host, [np.array([0]), np.array([1])]))) == 2
    mesh.gradient_mean([torch.ones(2)])  # no group: no collective
    new = tracing.calls - calls
    assert new["data/gather"] == 1
    assert new["data/wait"] == 3  # two batches and the end
    assert new["collective/all_reduce"] == 0


def event(name, start, end, device, annotation=False, **more):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation, cpu_parent=None,
                           **more)


def test_an_annotation_over_the_window_is_not_busy():
    """The one device-work filter: a span mirrored over a whole window on
    the device's timeline counts as no work."""
    span = tracing.PREFIX + "step"
    events = [event(span, 0, 1000, CPU, True),
              event(span, 0, 1000, CUDA, True),
              event("gemm", 100, 300, CUDA),
              event("Memcpy DtoH", 500, 600, CUDA)]
    work = tracing.device_work(events)
    assert [e.name for e in work] == ["gemm", "Memcpy DtoH"]
    assert tracing.busy_seconds(work) == pytest.approx(300e-6)
    # without a recorded kind, a name that a host event has marks a span
    for e in events:
        del e.is_user_annotation
    assert [e.name for e in tracing.device_work(events)] == [
        "gemm", "Memcpy DtoH"]


def nested_profile(mirrored: bool) -> list:
    """A step span over a critic span and a generator span on the host. The
    critic launches two kernels (one from another thread, as the autograd
    engine does), the generator one, and one kernel is launched outside
    every span. ``mirrored``: the profiler also put the spans on the
    device's timeline, each over its own launches."""
    p = tracing.PREFIX
    host = [event(p + "step", 0, 100, CPU, True),
            event(p + "step/critic", 0, 50, CPU, True),
            event(p + "step/generator", 50, 100, CPU, True),
            event("aten::conv1d", 10, 20, CPU, id=1),
            event("cudaLaunchKernel", 15, 16, CPU, id=11),
            event("cudaLaunchKernel", 30, 31, CPU, id=12),
            event("cuLaunchKernel", 65, 66, CPU, id=13),
            event("cudaMemcpyAsync", 200, 201, CPU, id=14)]
    device = [event("conv_a", 100, 150, CUDA, id=11),
              event("conv_b", 140, 200, CUDA, id=12),
              event("gemm", 210, 240, CUDA, id=13),
              event("Memcpy DtoH", 400, 410, CUDA, id=14)]
    if mirrored:
        device += [event(p + "step/critic", 100, 150, CUDA, True, id=0),
                   event(p + "step/generator", 210, 240, CUDA, True, id=0)]
    return host + device


@pytest.mark.parametrize("mirrored", [False, True],
                         ids=["host_spans", "with_device_annotations"])
def test_device_seconds_under_nested_spans(mirrored):
    seconds = tracing.span_device_seconds(nested_profile(mirrored))
    assert seconds == pytest.approx({"step": 130e-6, "step/critic": 100e-6,
                                     "step/generator": 30e-6})
