"""The cells ``wavegan-train`` and ``sl2048-train-streamed`` at a tiny size
on the CPU, in float32: the WaveGAN loop against its reference, the
control and the faults its limits refuse (fp8 products, half the batch, a
state left unchanged), the streamed loop's batches and readings against
the ``DeviceStore`` loop's bit for bit, their files and readers found by
name, each new reader on synthetic counts and without them, and the work
count by hand.

The tiny WaveGAN cell is the tier-1 test's size (d 4, 25 taps, stride 4,
2048 frames, 3 channels, batch 2) at learning rate 1e-5, for the reason
``test_h100bench_train2d.py`` gives."""

from __future__ import annotations

import collections
import math
import sys
import time

import pytest
import torch

from h100bench import compare, registry, run, work_wave
from h100bench.loops import train as train_loop
from h100bench.loops import train2d, train_streamed, trainwave
from h100bench.reference import model

from conftest import SEED, TINY_MIX, TINY_MODEL

CELL, STREAMED = "wavegan-train", "sl2048-train-streamed"
TINY_WAVE = dict(sequence_length=2048, num_neurons=3, num_channels=3,
                 noise_dim=8, num_units=4, mixed_precision=False,
                 learning_rate=1e-5)
TINY_WAVE_MIX = dict(batch_size=2, rows=8, warm_steps=1, traced_steps=2)
READERS = ("convt1d_zero_products_pct", "conv_zero_products_pct")


def tiny_cell(**model) -> dict:
    cell = registry.cell(CELL)
    cell["config_data"].update(TINY_WAVE, **model)
    cell["traffic_data"].update(TINY_WAVE_MIX)
    return cell


def tiny_streamed(name: str = STREAMED) -> dict:
    cell = registry.cell(name)
    cell["config_data"].update(TINY_MODEL)
    cell["traffic_data"].update(TINY_MIX["train"])
    return cell


def _correct(cell, result) -> bool:
    return run.result_line(cell, result, False)["correct"]


def test_loop_matches_the_reference(monkeypatch):
    from calciumgan_tpu_torch.utils import tracing
    # the readers read the process's counts: this run's alone
    monkeypatch.setattr(tracing, "totals", collections.Counter())
    monkeypatch.setattr(tracing, "calls", collections.Counter())
    cell = tiny_cell()
    result = trainwave.run(cell, SEED, 0.0, True, time.time(), device="cpu")
    for value in result["numbers"].values():
        assert value <= 1e-4
    assert _correct(cell, result) is True
    line = run.result_line(cell, result, True)
    # the cropped route multiplies the cropped frames' pairs: (input
    # frames, Cin, Cout, pairs cropped) a layer at 25 taps, stride 4; the
    # critic's layers multiply a zero tap, 26 taps for 25
    layers = [(2, 64, 32, 34), (8, 32, 16, 39), (32, 16, 8, 39),
              (128, 8, 4, 39), (512, 4, 3, 39)]
    every = sum(w * 25 * a * b for w, a, b, _ in layers)
    cropped = sum(c * a * b for _, a, b, c in layers)
    assert line["metrics"]["convt1d_zero_products_pct"]["value"] == \
        pytest.approx(100.0 * cropped / every)
    assert line["metrics"]["conv_zero_products_pct"]["value"] == \
        pytest.approx(100.0 / 26)
    assert result["context"]["traced_steps"] == 2
    assert result["context"]["step_flops"] == work_wave.train_step_flops(
        cell["config_data"], 2)


def test_state_unchanged(monkeypatch):
    from calciumgan_tpu_torch.algorithms import wgan_gp
    monkeypatch.setattr(wgan_gp, "apply_updates", lambda net, grads: None)
    cell = tiny_cell()
    result = trainwave.run(cell, SEED, 0.0, False, time.time(), device="cpu")
    assert result["numbers"]["change_gap"] == 1.0
    assert not _correct(cell, result)


@pytest.mark.parametrize("kind", ["fp8", "half_batch"])
def test_reference_control_and_fault_fail_the_limits(kind):
    """The reference with fp8 products, or over half the batch, in the
    program's place: far past float32 rounding at this size, and
    ``correct`` false under the cell's limits."""
    cell = tiny_cell(num_units=8)
    cfg, mix = cell["config_data"], cell["traffic_data"]
    ref = trainwave.reference_readings(cfg, mix, SEED, "cpu")
    kw = ({"cast": model.fp8_cast} if kind == "fp8"
          else {"rows": mix["batch_size"] // 2})
    other = trainwave.reference_readings(cfg, mix, SEED, "cpu", **kw)
    numbers = train2d.numbers(other, ref)
    assert numbers["grad_gap"] > 0.01
    correct, checks = compare.judge(numbers, registry.limits(CELL))
    assert checks["first_grad_gap"]["value"] > \
        checks["first_grad_gap"]["limit"]
    assert correct is False


def _recorded(trainer, steps: int) -> list:
    """``(batch, losses)`` of ``trainer``'s first ``steps`` steps."""
    seen = []
    step = trainer.algo.train_step

    def record(state, real, draws):
        logs = step(state, real, draws)
        seen.append((real.clone(), {n: float(logs[n])
                                    for n in compare.LOSSES}))
        return logs

    trainer.algo.train_step = record
    for k in range(steps):
        trainer.step(k)
    return seen


def test_streamed_batches_and_losses_equal_the_store_loops():
    """Two epochs and a half: every batch and loss bit for bit, across the
    epoch boundaries, where a new prefetcher starts."""
    cell = tiny_streamed()
    cfg, mix = cell["config_data"], cell["traffic_data"]
    device = torch.device("cpu")
    store = train_loop.Trainer(cfg, mix, SEED, ["cpu"], 0, device)
    streamed = train_streamed.StreamedTrainer(cfg, mix, SEED, device)
    assert not hasattr(streamed, "store")
    steps = 2 * (mix["rows"] // mix["batch_size"]) + 2
    for (a, la), (b, lb) in zip(_recorded(store, steps),
                                _recorded(streamed, steps), strict=True):
        assert torch.equal(a, b)
        assert la == lb
    with pytest.raises(ValueError, match="next"):
        streamed.step(0)


def test_streamed_loop_reads_what_the_store_loop_reads():
    cell = tiny_streamed()
    store = tiny_streamed("sl2048-train")
    result = train_streamed.run(cell, SEED, 0.0, True, time.time(),
                                device="cpu")
    expected = train_loop.run(store, SEED, 0.0, False, time.time(),
                              device="cpu")
    assert result["numbers"] == expected["numbers"]
    assert _correct(cell, result) is True
    assert registry.limits(STREAMED) == registry.limits("sl2048-train")
    line = run.result_line(cell, result, True)
    assert set(line["metrics"]) == {"train_mfu_pct",
                                    "device_idle_pct.train"}


def test_the_registry_finds_the_cells():
    wave, streamed = registry.cell(CELL), registry.cell(STREAMED)
    assert wave["chips"] == streamed["chips"] == 1
    assert wave["config_data"]["model"] == "wavegan_paper"
    assert wave["config_data"]["reduced"] == []
    assert set(registry.limits(CELL)) == {"change_gap", "first_grad_gap"}
    assert (wave["traffic_data"]["loop"], streamed["traffic_data"]["loop"]) \
        == ("trainwave", "train_streamed")
    base = registry.cell("sl2048-train")
    assert streamed["config_data"] == base["config_data"]
    assert {k: v for k, v in streamed["traffic_data"].items()
            if k not in ("loop", "about")} == {
        k: v for k, v in base["traffic_data"].items()
        if k not in ("loop", "about")}
    # the streamed cell's 4-step epochs put a new prefetcher's first batch
    # on every fourth step, which the p90 reads: it is left out there
    for name, p90 in ((CELL, {"train_step_p90_ms"}), (STREAMED, set())):
        e2e = {m["name"] for m in registry.metrics_for("end_to_end", name)}
        assert e2e == {"train_samples_per_s", "setup_s", *p90}
    layer = {m["name"] for m in registry.metrics_for("per_layer", CELL)}
    assert layer == {"train_mfu_pct", "device_idle_pct.train", *READERS}
    for name in layer:
        assert callable(registry.reader(name))


@pytest.fixture
def counted(monkeypatch):
    from calciumgan_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "totals", collections.Counter({
        "conv_transpose1d/products": 400,
        "conv_transpose1d/work_products": 100,
        "conv/products": 260, "conv/work_products": 250}))


def test_readers_on_synthetic_counts(counted):
    assert registry.reader("convt1d_zero_products_pct")({}) == \
        pytest.approx(75.0)
    assert registry.reader("conv_zero_products_pct")({}) == \
        pytest.approx(100.0 / 26)


@pytest.mark.parametrize("name", READERS)
def test_readers_before_any_call(monkeypatch, name):
    from calciumgan_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "totals", collections.Counter())
    monkeypatch.setattr(tracing, "calls", collections.Counter())
    assert registry.reader(name)({}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_program_counters(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "calciumgan_tpu_torch.utils.tracing",
                        None)
    assert registry.reader(name)({}) is None


# d 1, kernel 3, stride 2, 64 frames (noise width 2), 2 channels, noise 3
CFG = dict(noise_dim=3, num_units=1, kernel_size=3, num_channels=2,
           sequence_length=64, strides=2, n_critic=5)


def test_generator_work_by_hand():
    B = 3
    dense = 2 * B * 3 * (2 * 16)  # noise 3 -> 2 frames x 16 channels
    # input frames x 3 taps x Cin x Cout: 16 -> 8 -> 4 -> 2 -> 1 -> 2
    convs = 2 * B * 3 * (2 * 16 * 8 + 4 * 8 * 4 + 8 * 4 * 2 + 16 * 2 * 1
                         + 32 * 1 * 2)
    assert work_wave.generator_flops(CFG, B) == dense + convs


def test_critic_work_by_hand():
    B = 3
    # output frames x 3 taps x Cin x Cout: 2 -> 1 -> 2 -> 4 -> 8 -> 16
    convs = 2 * B * 3 * (32 * 2 * 1 + 16 * 1 * 2 + 8 * 2 * 4 + 4 * 4 * 8
                         + 2 * 8 * 16)
    assert work_wave.critic_flops(CFG, B) == convs + 2 * B * 2 * 16


def test_recipe_step_work():
    """About 3.02 GFLOP a sample in each net, 11.58 TFLOP a step of 64."""
    cfg = registry.cell(CELL)["config_data"]
    assert work_wave.generator_flops(cfg, 1) == pytest.approx(3.018e9,
                                                              rel=1e-3)
    assert work_wave.critic_flops(cfg, 1) == pytest.approx(3.015e9,
                                                           rel=1e-3)
    assert work_wave.train_step_flops(cfg, 64) == pytest.approx(
        11.578e12, rel=1e-4)
    assert math.isclose(work_wave.train_step_flops(cfg, 64),
                        64 * work_wave.train_step_flops(cfg, 1))


@pytest.mark.card
@pytest.mark.parametrize("name", [CELL, STREAMED])
def test_cell_runs_correct_on_the_card(card, name):
    import json
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", name,
         "--seed", str(2 ** 33 + 7), "--seconds", "3", "--trace", "0"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
