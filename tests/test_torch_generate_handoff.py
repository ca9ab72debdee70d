"""Serving's handoff to the host: ``generate``'s payloads and the OASIS
dispatch's spikes as host arrays.

On the CPU the payloads are the generator's signals and the dispatch's
spikes bit for bit, C-contiguous, kept intact while the generator runs on,
and the ``to_host/*`` counters count no page-locked byte. The tests marked
``card`` hold the CUDA path to the same on an NVIDIA GPU (every byte
crosses by DMA into page-locked memory, spikes laid out on the card) and
skip without one. This file imports no JAX, so that on the card it runs
alone: ``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_generate_handoff.py -q``.
"""

import numpy as np
import pytest
import torch

from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.algorithms import gan
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data.pipeline import reverse_preprocessing
from calciumgan_tpu_torch.eval.spike_eval import deconvolve_traces
from calciumgan_tpu_torch.generate import build_generator, generate
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.ops import golden
from calciumgan_tpu_torch.ops.oasis import deconvolve_signals_host
from calciumgan_tpu_torch.utils import crossing, tracing

SEED = 11


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def served(T: int, channels: int = 6, units: int = 4):
    """A seeded calciumgan generator of ``T`` frames: its config and Flax
    variables, as ``generate`` takes them."""
    config = Config(
        model="calciumgan", algorithm="wgan-gp", sequence_length=T,
        num_neurons=channels, num_channels=channels,
        signal_shape=(T, channels), noise_dim=8, num_units=units,
        kernel_size=8, strides=2, m=2, layer_norm=True, n_critic=5,
        normalize=True, signals_min=0.0, signals_max=1.0, seed=SEED)
    generator, _ = get_models(config, rng=torch.Generator().manual_seed(3))
    return config, convert.flax_generator_variables(generator.state_dict())


def expected(config, variables, num_samples: int, batch_size: int,
             device: str, seed: int = SEED):
    """Each batch's signals and spikes worked out again: the generator on
    the same noise, its signals copied to the host, and the dispatch's
    spikes of the contiguous ``(n, C, T)`` traces transposed on the host."""
    generator = build_generator(config, variables, device)
    rng = torch.Generator(device=device).manual_seed(seed)
    out = []
    for lo in range(0, num_samples, batch_size):
        noise = gan.get_noise(rng, batch_size, config.noise_dim, device)
        signals = reverse_preprocessing(config, gan.generate(
            generator, noise))[:num_samples - lo].float()
        spikes = deconvolve_traces(signals.transpose(1, 2).contiguous())
        out.append((signals.cpu().numpy().copy(),
                    np.transpose(spikes, (0, 2, 1)).copy()))
    return out


def check_payloads(payloads, want, shape_tail):
    assert len(payloads) == len(want)
    for p, (signals, spikes) in zip(payloads, want):
        assert list(p) == ["signals", "spikes"]
        for name, ref, dtype in (("signals", signals, np.float32),
                                 ("spikes", spikes, np.int8)):
            a = p[name]
            assert isinstance(a, np.ndarray) and a.dtype == dtype
            assert a.shape == (len(signals),) + shape_tail
            assert a.flags.c_contiguous, name
            np.testing.assert_array_equal(a, ref)
    assert sum(int(p["spikes"].sum()) for p in payloads) > 0


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_samples, batch_size", [(7, 3), (4, 4)])
def test_cpu_payloads_are_the_generator_and_the_dispatch(num_samples,
                                                         batch_size):
    config, variables = served(64)
    payloads = list(generate(config, variables, num_samples, batch_size,
                             with_spikes=True, seed=SEED, device="cpu"))
    check_payloads(payloads,
                   expected(config, variables, num_samples, batch_size,
                            "cpu"), (64, 6))
    # and the dispatch's spikes are the float64 golden's
    for p in payloads:
        traces = np.transpose(p["signals"], (0, 2, 1)).reshape(-1, 64)
        ref = golden.golden_spikes(traces).reshape(-1, 6, 64)
        np.testing.assert_array_equal(
            p["spikes"], np.transpose(ref, (0, 2, 1)).astype(np.int8))


def test_cpu_payloads_held_stay_unchanged():
    config, variables = served(64)
    batches = generate(config, variables, 3 * 6, 3, with_spikes=True,
                       seed=SEED, device="cpu")
    held = [next(batches) for _ in range(3)]
    copies = [{k: v.copy() for k, v in p.items()} for p in held]
    rest = list(batches)
    assert len(rest) == 3
    for p, c in zip(held, copies):
        for name in ("signals", "spikes"):
            np.testing.assert_array_equal(p[name], c[name])
            assert not any(np.shares_memory(p[name], q[name])
                           for q in held + rest if q is not p)


@pytest.mark.parametrize("T", [64, 4608])
def test_permuted_view_equals_the_contiguous_copy(T):
    rng = np.random.default_rng([SEED, T])
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(
        golden.synth_ar1_traces(rng, 2 * 5, T).reshape(2, 5, T),
        (0, 2, 1))).astype(np.float32))  # (n, T, C)
    view = x.transpose(1, 2)
    got = deconvolve_signals_host(view)
    want = deconvolve_signals_host(view.contiguous())
    assert got.shape == want.shape == (2, 5, T) and got.dtype == np.int8
    assert got.strides == (T * 5, 1, 5)
    assert np.transpose(got, (0, 2, 1)).flags.c_contiguous
    assert want.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_cpu_counts_bytes_and_no_pinned_byte():
    config, variables = served(64)
    calls = dict(tracing.calls)
    before = dict(tracing.totals)
    payloads = list(generate(config, variables, 6, 3, with_spikes=True,
                             seed=SEED, device="cpu"))

    def grew(name, counter=tracing.totals, start=before):
        return counter[name] - start.get(name, 0)

    handed = sum(p["signals"].nbytes + p["spikes"].nbytes for p in payloads)
    assert grew("to_host/bytes") == handed
    assert grew("to_host/pinned_bytes") == 0
    # two signals_to_host spans a batch (issued, waited), one spikes'
    for name, per_batch in (("generate/batch", 1),
                            ("generate/signals_to_host", 2),
                            ("oasis/spikes_to_host", 1)):
        assert grew(name, tracing.calls, calls) == per_batch * 2, name


def test_cpu_tensor_is_handed_over_as_it_lies():
    t = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    view = t.transpose(1, 2)
    a = crossing.to_host(view)
    assert np.shares_memory(a, t.numpy())
    np.testing.assert_array_equal(a, view.numpy())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("T, batch_size", [(2048, 6), (16384, 2)])
def test_card_payloads_match_the_pageable_path(card, monkeypatch, T,
                                               batch_size):
    """Each payload against the parent's path on the very device tensors
    it was made from: the signals' pageable ``.cpu()``, and the spikes of
    the contiguous ``(n, C, T)`` traces transposed on the host (and those
    of the CPU dispatch, the float64 redo's)."""
    from calciumgan_tpu_torch import generate as generate_mod
    handed, traced = [], []
    start, deconvolve = crossing.start, generate_mod.deconvolve_traces

    def spy_start(tensor, stream=None):  # the dispatch's spikes too
        if tensor.is_floating_point():
            handed.append(tensor.cpu().numpy())
        return start(tensor, stream)

    def spy_deconvolve(traces):
        traced.append(traces)
        return deconvolve(traces)

    monkeypatch.setattr(generate_mod.crossing, "start", spy_start)
    monkeypatch.setattr(generate_mod, "deconvolve_traces", spy_deconvolve)
    config, variables = served(T, channels=102, units=16)
    num_samples = 2 * batch_size + 1
    payloads = list(generate(config, variables, num_samples, batch_size,
                             with_spikes=True, seed=SEED, device="cuda"))
    monkeypatch.undo()
    assert len(handed) == len(traced) == len(payloads) == 3
    want = []
    for signals, traces in zip(handed, traced):
        assert traces.is_cuda and not traces.is_contiguous()
        spikes = deconvolve_signals_host(traces.contiguous())
        np.testing.assert_array_equal(
            spikes, deconvolve_signals_host(traces.cpu()))
        want.append((signals, np.transpose(spikes, (0, 2, 1))))
    check_payloads(payloads, want, (T, 102))
    for p in payloads:
        for a in p.values():
            assert torch.from_numpy(a).is_pinned()


@pytest.mark.card
def test_card_payloads_held_across_batches_stay_intact(card):
    config, variables = served(2048, channels=102, units=16)
    batches = generate(config, variables, 6 * 4, 4, with_spikes=True,
                       seed=SEED, device="cuda")
    held = [next(batches) for _ in range(3)]
    copies = [{k: v.copy() for k, v in p.items()} for p in held]
    rest = list(batches)
    assert len(rest) == 3
    for p, c in zip(held, copies):
        for name in ("signals", "spikes"):
            np.testing.assert_array_equal(p[name], c[name])
            assert not any(np.shares_memory(p[name], q[name])
                           for q in held + rest if q is not p)


@pytest.mark.card
@pytest.mark.parametrize("T", [2048, 16384])
def test_card_spikes_follow_a_permuted_view(card, T):
    rng = np.random.default_rng([SEED, T])
    n, C = 3, 40
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(
        golden.synth_ar1_traces(rng, n * C, T).reshape(n, C, T),
        (0, 2, 1))).astype(np.float32)).cuda()  # (n, T, C)
    got = deconvolve_signals_host(x.transpose(1, 2))
    assert got.shape == (n, C, T) and got.strides == (T * C, 1, C)
    assert np.transpose(got, (0, 2, 1)).flags.c_contiguous
    assert torch.from_numpy(got).is_pinned()
    want = deconvolve_signals_host(x.transpose(1, 2).contiguous())
    assert want.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, deconvolve_signals_host(
        x.transpose(1, 2).cpu()))
    assert want.sum() > 0


@pytest.mark.card
def test_card_every_byte_crosses_pinned(card):
    config, variables = served(2048, channels=102, units=16)
    before = dict(tracing.totals)
    payloads = list(generate(config, variables, 4, 4, with_spikes=True,
                             seed=SEED, device="cuda"))
    grew = {k: tracing.totals[k] - before.get(k, 0)
            for k in ("to_host/bytes", "to_host/pinned_bytes")}
    handed = sum(a.nbytes for p in payloads for a in p.values())
    assert grew["to_host/pinned_bytes"] == grew["to_host/bytes"] == handed
