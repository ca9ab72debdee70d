"""OASIS AR(1) in the port vs the JAX Pallas kernel and the f64 golden.

The plain PyTorch version (``calciumgan_tpu_torch/ops/oasis_torch.py``, the
CUDA kernel's twin and the port's CPU path) runs against
``oasis_ar1_pallas(..., interpret=True)`` on the same numpy inputs, as
``tests/test_oasis_pallas.py:18-105`` runs the TPU kernel: ``c`` and ``s``
within atol 1e-4 (float32 pool arithmetic vs the f64 golden, as there) and
equal redo bitmasks. The dispatch's spikes must equal the f64 golden
exactly. The CUDA kernel itself is held against this plain version on the
card by ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from calciumgan_tpu.ops import oasis_ref
from calciumgan_tpu.ops.oasis_pallas import oasis_ar1_pallas
from calciumgan_tpu_torch.ops import oasis as oasis_dispatch
from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch

torch.set_num_threads(1)

ATOL = 1e-4


def synth_traces(rng, n=8, T=256, g=0.95, rate=0.02, sn=0.3):
    spikes = (rng.random((n, T)) < rate).astype(np.float64)
    c = np.zeros_like(spikes)
    for t in range(T):
        c[:, t] = spikes[:, t] + (g * c[:, t - 1] if t > 0 else 0.0)
    return c + sn * rng.standard_normal((n, T))


def run_both(y, **kw):
    """(Pallas interpret, plain PyTorch) results as numpy triples."""
    ref = tuple(map(np.asarray, oasis_ar1_pallas(y, interpret=True, **kw)))
    out = oasis_torch.oasis_ar1_torch(
        torch.from_numpy(np.asarray(y, np.float32)), **kw)
    return ref, tuple(t.numpy() for t in out)


@pytest.mark.parametrize("s_min,lam", [(0.55, 0.0), (0.0, 0.0), (0.0, 1.0)])
def test_matches_pallas_and_golden(rng, s_min, lam):
    y = synth_traces(rng, n=6, T=220)
    (c_j, s_j, redo_j), (c, s, redo) = run_both(y, g=0.95, lam=lam,
                                                 s_min=s_min)
    np.testing.assert_array_equal(redo, redo_j)
    assert not redo.any()
    np.testing.assert_allclose(c, c_j, atol=ATOL)
    np.testing.assert_allclose(s, s_j, atol=ATOL)
    for i in range(len(y)):
        c_ref, s_ref = oasis_ref.oasis_ar1(y[i], g=0.95, lam=lam, s_min=s_min)
        np.testing.assert_allclose(c[i], c_ref, atol=ATOL)
        np.testing.assert_allclose(s[i], s_ref, atol=ATOL)


def test_batch_shape_and_multi_block(rng):
    # >128 traces (two TPU lane blocks) in a 3-D batch
    y = synth_traces(rng, n=130, T=64).reshape(13, 10, 64)
    (c_j, s_j, redo_j), (c, s, redo) = run_both(y, g=0.95, s_min=0.55)
    assert c.shape == y.shape and s.shape == y.shape
    assert redo.shape == (13, 10)
    np.testing.assert_array_equal(redo, redo_j)
    np.testing.assert_allclose(c, c_j, atol=ATOL)
    np.testing.assert_allclose(s, s_j, atol=ATOL)


def test_redo_bit0_on_stack_overflow():
    # a monotone ramp at s_min=0 keeps every pool: depth = T > tiny cap
    ramp = np.linspace(0.0, 10.0, 64)[None].repeat(3, 0)
    (_, _, redo_j), (_, _, redo) = run_both(ramp, s_min=0.0, depth=8)
    np.testing.assert_array_equal(redo, redo_j)
    assert (redo & 1).all()


def test_redo_bit1_on_merge_budget():
    # a long decay after a big spike forces a cascade of merges at one
    # timestep; merge_attempts=1 cannot resolve it
    T = 96
    c = np.zeros(T)
    for t in range(T):
        c[t] = (5.0 if t == 5 else 0.0) + (0.95 * c[t - 1] if t else 0.0)
    y = (c + 0.3 * np.sin(np.arange(T)))[None]
    (_, _, redo1_j), (_, s1, redo1) = run_both(y, s_min=0.55,
                                               merge_attempts=1)
    (_, s4_j, redo4_j), (_, s4, redo4) = run_both(y, s_min=0.55,
                                                  merge_attempts=4)
    np.testing.assert_array_equal(redo1, redo1_j)
    np.testing.assert_array_equal(redo4, redo4_j)
    # the full budget is exact and unflagged; the starved one must match
    # anyway or flag itself
    assert not redo4.any()
    _, s_ref = oasis_ref.oasis_ar1(y[0], g=0.95, s_min=0.55)
    np.testing.assert_allclose(s4[0], s_ref, atol=ATOL)
    np.testing.assert_allclose(s4, s4_j, atol=ATOL)
    if not np.allclose(s1[0], s_ref, atol=ATOL):
        assert redo1[0] & 2


def test_redo_bit2_borderline():
    # margin 1e-7 sits inside the band flag_tol*(1+|rhs|) ~ 2.5e-5
    g, s_min, a = 0.95, 0.55, 2.0
    y = np.zeros((1, 64), np.float32)
    y[0, 0] = a
    y[0, 1] = g * a + s_min + 1e-7
    for tol in (1e-5, 0.0):
        (_, _, redo_j), (_, _, redo) = run_both(y, g=g, s_min=s_min,
                                                flag_tol=tol)
        np.testing.assert_array_equal(redo, redo_j)
        assert bool(redo[0] & 4) == (tol > 0)
    y[0, 1] = g * a + s_min + 0.2  # comfortably outside the band
    (_, _, redo_j), (_, _, redo) = run_both(y, g=g, s_min=s_min,
                                            flag_tol=1e-5)
    np.testing.assert_array_equal(redo, redo_j)
    assert not redo[0] & 4


def test_flagged_bits_match_on_dense_traces(rng):
    # overflow and budget flags on dense data with a shallow stack and a
    # starved budget; the ring-buffer stack sees the same pools as the
    # rolled Pallas stack even after an overflow
    y = np.concatenate([synth_traces(rng, n=20, T=128, rate=0.02),
                        synth_traces(rng, n=20, T=128, rate=0.3)])
    seen = 0
    for K in (1, 2):
        (c_j, _, redo_j), (c, _, redo) = run_both(
            y, s_min=0.55, depth=24, merge_attempts=K, flag_tol=1e-5)
        np.testing.assert_array_equal(redo, redo_j)
        ok = redo == 0
        np.testing.assert_allclose(c[ok], c_j[ok], atol=ATOL)
        seen |= np.bitwise_or.reduce(redo)
    assert seen & 1 and seen & 2 and (redo == 0).any()


def test_deconvolve_signals_host_equals_golden(rng):
    y = synth_traces(rng, n=24, T=256).astype(np.float32)
    spikes = oasis_dispatch.deconvolve_signals_host(torch.from_numpy(y))
    assert spikes.dtype == np.int8 and spikes.shape == y.shape
    golden = oasis_ref.deconvolve_signals_ref(y.astype(np.float64))
    np.testing.assert_array_equal(spikes, golden.astype(np.int8))


def test_ladder_escalates_on_depth_flags(rng, monkeypatch):
    """More than 10% of lanes depth-flag -> the whole batch re-runs one rung
    deeper; otherwise one dispatch, and the flagged lanes are redone in f64
    on the host. Spikes equal the golden either way."""
    depths = []
    real = oasis_cuda.oasis_ar1

    def spy(signals, **kw):
        depths.append(kw["depth"])
        return real(signals, **kw)

    monkeypatch.setattr(oasis_cuda, "oasis_ar1", spy)
    T = 200
    # increments of 0.6 > s_min: no merge ever, every frame its own pool
    ramp = (0.6 * np.arange(T, dtype=np.float32))[None]
    spiky = synth_traces(rng, n=19, T=T).astype(np.float32)
    for y, expect in ((np.concatenate([ramp.repeat(3, 0), spiky[:5]]),
                       [64, 160, 200]),           # 3/8 lanes overflow
                      (np.concatenate([ramp, spiky]), [64])):  # 1/20
        depths.clear()
        spikes = oasis_dispatch.deconvolve_signals_host(y)
        assert depths == expect
        golden = oasis_ref.deconvolve_signals_ref(y.astype(np.float64))
        np.testing.assert_array_equal(spikes, golden.astype(np.int8))


def test_exact_host_redo_on_threads_equals_golden(rng, monkeypatch):
    # the C++ float64 kernel built by the port, rows spread over threads;
    # random traces put many decisions near the band, spiky ones few
    y = np.concatenate([synth_traces(rng, n=300, T=128),
                        rng.random((300, 128))]).astype(np.float32)
    golden = oasis_ref.deconvolve_signals_ref(y.astype(np.float64))
    monkeypatch.setattr(oasis_dispatch, "_HOST_ROWS_PER_THREAD", 64)
    spikes = oasis_dispatch._exact_spikes_host(y, 0.95, 0.55, 0.5)
    assert spikes.dtype == np.int8
    np.testing.assert_array_equal(spikes, golden.astype(np.int8))

    def no_compiler():
        raise RuntimeError("no C++ compiler")

    # a failed build raises: no quiet fall back to a ~100x slower path
    monkeypatch.setattr(oasis_dispatch, "host_library", no_compiler)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        oasis_dispatch._exact_spikes_host(y[:4], 0.95, 0.55, 0.5)


def test_port_golden_is_the_numpy_reference(rng):
    # what chip_smoke.py holds the card's spikes to
    from calciumgan_tpu_torch.ops import golden
    y = golden.synth_ar1_traces(rng, 6, 200).astype(np.float32)
    spikes = golden.golden_spikes(y)
    assert spikes.dtype == np.int8 and spikes.shape == y.shape
    np.testing.assert_array_equal(spikes, oasis_ref.deconvolve_signals_ref(
        y.astype(np.float64)).astype(np.int8))
    np.testing.assert_array_equal(spikes, oasis_dispatch._exact_spikes_host(
        y, 0.95, 0.55, 0.5))


def test_long_traces_on_cpu_take_the_exact_host_path(rng):
    y = synth_traces(rng, n=2, T=4100).astype(np.float32)
    before = oasis_torch.calls
    spikes = oasis_dispatch.deconvolve_signals_host(y)
    assert oasis_torch.calls == before
    golden = oasis_ref.deconvolve_signals_ref(y.astype(np.float64))
    np.testing.assert_array_equal(spikes, golden.astype(np.int8))


def test_dispatch_contract():
    # precise=True runs the precise twin on a CPU tensor; the kernel's
    # wrapper refuses a CPU tensor; no launch is counted
    y = torch.zeros((2, 16))
    before = oasis_torch.calls
    c, s, redo = oasis_cuda.oasis_ar1(y, precise=True)
    assert oasis_torch.calls == before + 1
    assert c.shape == s.shape == (2, 16) and redo.shape == (2,)
    assert not redo.any() and not c.any()
    with pytest.raises(ValueError, match="CUDA"):
        oasis_cuda.oasis_ar1_cuda(y)
    with pytest.raises(ValueError, match="CUDA"):
        oasis_cuda.oasis_ar1_cuda(y, precise=True)
    assert not oasis_cuda.launches


def test_cpu_branch_needs_no_nvcc_and_no_triton(tmp_path):
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from calciumgan_tpu_torch.kernels import build\n"
        "from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch\n"
        "c, s, redo = oasis_cuda.oasis_ar1(torch.rand(3, 40), s_min=0.55)\n"
        "assert c.shape == s.shape == (3, 40) and redo.shape == (3,)\n"
        "assert oasis_torch.calls == 1 and not oasis_cuda.launches\n"
        "try:\n"
        "    build.nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(tmp_path / "no-cuda"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no nvcc"
