"""The port's in-graph OASIS API against the JAX package's, on the CPU.

``oasis_ar1_while`` (plain PyTorch) runs against ``oasis_ar1_jax`` (XLA's
``while_loop``) on the seeded inputs of ``tests/test_oasis.py:23-65`` and
``tests/test_oasis_pallas.py:206-220``: equal spikes at the 0.5 threshold,
and ``c``, ``s`` within ATOL. The two agree to float32 rounding, not bit
for bit: XLA's CPU ``exp`` and torch's differ by an ulp on about one value
in eight, and ``g^e`` is ``exp(e * log g)`` in both (a pool of calcium up
to ~20 holds 2e-6 per ulp). ``deconvolve_signals`` must equal the JAX
package's exactly: ``backend="while"`` against ``"while"``, and the kernel
backend (on the CPU its plain twin) against ``"pallas"`` under interpret, as
the JAX tests run it, including the redo rows forced by a small ``depth``.
"""

import types

import numpy as np
import pytest
import torch

from calciumgan_tpu.ops.oasis import deconvolve_signals as jax_deconvolve
from calciumgan_tpu.ops.oasis import oasis_ar1_jax
from calciumgan_tpu.ops.oasis_pallas import oasis_ar1_pallas
from calciumgan_tpu_torch.ops import golden, oasis, oasis_torch

torch.set_num_threads(1)

ATOL = 1e-5


def synth_traces(rng, n=8, T=256, g=0.95, rate=0.02, sn=0.3):
    """``tests/test_oasis.py``'s traces: AR(1) calcium plus noise."""
    spikes = (rng.random((n, T)) < rate).astype(np.float64)
    c = np.zeros_like(spikes)
    for t in range(T):
        c[:, t] = spikes[:, t] + (g * c[:, t - 1] if t > 0 else 0.0)
    return c + sn * rng.standard_normal((n, T))


def port_spikes(y, **kw):
    return oasis.deconvolve_signals(torch.from_numpy(np.asarray(y)),
                                    **kw).numpy()


@pytest.mark.parametrize("n,T,s_min,lam,rate", [
    (1, 300, 0.55, 0.0, 0.02), (16, 200, 0.0, 0.0, 0.02),
    (16, 200, 0.55, 0.0, 0.02), (16, 200, 0.0, 1.0, 0.02),
    (8, 256, 0.55, 0.0, 0.3), (4, 2048, 0.55, 0.0, 0.05)])
def test_while_matches_oasis_ar1_jax(rng, n, T, s_min, lam, rate):
    y = synth_traces(rng, n, T, rate=rate)
    c_j, s_j = map(np.asarray, oasis_ar1_jax(y, g=0.95, lam=lam,
                                             s_min=s_min))
    c, s = (x.numpy() for x in oasis.oasis_ar1_while(
        torch.from_numpy(y), g=0.95, lam=lam, s_min=s_min))
    assert c.dtype == s.dtype == np.float32 and c.shape == y.shape
    np.testing.assert_allclose(c, c_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(s, s_j, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(s > 0.5, s_j > 0.5)
    for i in range(n):  # and the float64 golden, as tests/test_oasis.py
        c_ref, s_ref = golden.oasis_ar1(y[i], g=0.95, lam=lam, s_min=s_min)
        np.testing.assert_allclose(c[i], c_ref, atol=1e-4)
        np.testing.assert_allclose(s[i], s_ref, atol=1e-4)


@pytest.mark.parametrize("backend,jax_backend", [("while", "while"),
                                                 ("kernel", "pallas")])
@pytest.mark.parametrize("shape", [(8, 256), (2, 3, 200), (200,)])
def test_deconvolve_signals_equals_jax(rng, backend, jax_backend, shape):
    y = synth_traces(rng, int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    ours = port_spikes(y, backend=backend)
    theirs = np.asarray(jax_deconvolve(y, backend=jax_backend))
    assert ours.dtype == np.float32 and ours.shape == shape
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        ours.reshape(-1, shape[-1]),
        golden.golden_spikes(y.reshape(-1, shape[-1])))


@pytest.mark.parametrize("backend", ["while", "kernel"])
def test_zero_trace_and_clean_spikes(backend):
    assert port_spikes(np.zeros((2, 64)), backend=backend).sum() == 0
    assert port_spikes(np.zeros((0, 64)), backend=backend).shape == (0, 64)
    # a noiseless trace gives back its spike train (tests/test_oasis.py)
    T, g = 128, 0.95
    spikes = np.zeros(T)
    spikes[[10, 40, 90]] = 1.0
    c = np.zeros(T)
    for t in range(T):
        c[t] = spikes[t] + (g * c[t - 1] if t > 0 else 0.0)
    np.testing.assert_array_equal(port_spikes(c[None], backend=backend)[0],
                                  spikes)


def test_forced_redo_runs_the_while_machine_on_flagged_rows_only(
        rng, monkeypatch):
    """depth 8 overflows the busy traces' stacks (redo bit 0): those rows,
    and no other, go through ``oasis_ar1_while``, and every row's spikes
    equal JAX's, which reruns the whole batch."""
    y = np.concatenate([synth_traces(rng, 4, 200, rate=0.2),
                        synth_traces(rng, 4, 200, rate=0.0, sn=0.01)])
    _, _, redo = oasis_torch.oasis_ar1_torch(
        torch.from_numpy(y.astype(np.float32)), s_min=0.55, depth=8)
    _, _, redo_j = oasis_ar1_pallas(y, g=0.95, s_min=0.55, depth=8,
                                    interpret=True)
    np.testing.assert_array_equal(redo.numpy(), np.asarray(redo_j))
    flagged = np.nonzero(redo.numpy())[0]
    assert 0 < len(flagged) < len(y)

    seen = []
    machine = oasis.oasis_ar1_while

    def spy(rows, **kw):
        seen.append(rows.clone())
        return machine(rows, **kw)

    monkeypatch.setattr(oasis, "oasis_ar1_while", spy)
    ours = port_spikes(y, backend="kernel", depth=8)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].numpy(),
                                  y[flagged].astype(np.float32))
    theirs = np.asarray(jax_deconvolve(y, backend="pallas", depth=8))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, port_spikes(y, backend="while"))


def test_auto_takes_the_while_machine_beyond_4096_frames(rng):
    y = synth_traces(rng, 2, 5000)
    ours = port_spikes(y)  # a CPU tensor: "auto" is the while machine
    np.testing.assert_array_equal(ours, np.asarray(jax_deconvolve(y)))
    cuda = lambda T: types.SimpleNamespace(  # noqa: E731
        is_cuda=True, shape=(2, T))
    cpu = types.SimpleNamespace(is_cuda=False, shape=(2, 2048))
    assert oasis._in_graph_backend("auto", cuda(4096)) == "kernel"
    assert oasis._in_graph_backend("auto", cuda(4097)) == "while"
    assert oasis._in_graph_backend("auto", cpu) == "while"
    assert oasis._in_graph_backend("kernel", cpu) == "kernel"
    with pytest.raises(ValueError, match="pallas"):
        oasis._in_graph_backend("pallas", cpu)
