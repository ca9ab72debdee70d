"""The float64 reference the port's OASIS is held to: a copy of the JAX
package's numpy golden model (``calciumgan_tpu/ops/oasis_ref.py``), with its
synthetic trace maker.

It shares no code with the CUDA kernel, its plain PyTorch twin or the C++
float64 redo of :mod:`calciumgan_tpu_torch.ops.oasis`, so agreement with it
is an independent check. It is about 100x slower than the C++ redo: a
reference for checks, not a path of the dispatch.

Algorithm: Friedrich, Zhou & Paninski, "Fast online deconvolution of calcium
imaging data", PLoS Comput Biol 2017, Algorithm 1 for the AR(1) model with
a minimum spike size ``s_min`` and a sparsity penalty ``lam``: push each
sample as a singleton pool ``(v, w, t0, len)``; while the top pool's height
``v/w`` is below ``g**len_prev * (v/w)_prev + s_min``, merge it into its
left neighbour; then ``c[t0+k] = max(v/w, 0) * g**k`` and ``s[t] = c[t] -
g*c[t-1]``, ``s[0] = 0``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["oasis_ar1", "deconvolve_signals_ref", "golden_spikes",
           "synth_ar1_traces"]


def oasis_ar1(y: np.ndarray, g: float = 0.95, lam: float = 0.0,
              s_min: float = 0.0):
    """Deconvolve one ``(T,)`` trace in float64; returns ``(c, s)``."""
    y = np.asarray(y, dtype=np.float64)
    T = y.shape[0]
    if T == 0:
        return y.copy(), y.copy()

    # lam shifts the target: y - lam*(1-g), except the last sample (y - lam)
    yy = y - lam * (1.0 - g)
    yy[-1] = y[-1] - lam

    v = np.empty(T, dtype=np.float64)
    w = np.empty(T, dtype=np.float64)
    t0 = np.empty(T, dtype=np.int64)
    ln = np.empty(T, dtype=np.int64)

    p = -1  # stack top
    for t in range(T):
        p += 1
        v[p], w[p], t0[p], ln[p] = yy[t], 1.0, t, 1
        while p > 0 and (v[p] / w[p] <
                         g ** ln[p - 1] * (v[p - 1] / w[p - 1]) + s_min):
            gl = g ** ln[p - 1]
            v[p - 1] += gl * v[p]
            w[p - 1] += gl * gl * w[p]
            ln[p - 1] += ln[p]
            p -= 1

    c = np.empty(T, dtype=np.float64)
    for i in range(p + 1):
        h = max(v[i] / w[i], 0.0)
        c[t0[i]:t0[i] + ln[i]] = h * g ** np.arange(ln[i], dtype=np.float64)

    s = np.empty(T, dtype=np.float64)
    s[0] = 0.0
    s[1:] = c[1:] - g * c[:-1]
    return c, s


def synth_ar1_traces(rng, n: int, T: int, g: float = 0.95,
                     rate: float = 0.02, sn: float = 0.3) -> np.ndarray:
    """Noisy AR(1) calcium traces ``(n, T)`` float32 from a Bernoulli spike
    train of ``rate`` per frame, with Gaussian noise of scale ``sn``."""
    spikes = (rng.random((n, T)) < rate).astype(np.float32)
    traces = np.empty_like(spikes)
    acc = np.zeros(n, np.float32)
    for t in range(T):
        acc = g * acc + spikes[:, t]
        traces[:, t] = acc
    return traces + sn * rng.standard_normal(traces.shape).astype(np.float32)


def deconvolve_signals_ref(signals: np.ndarray, g: float = 0.95,
                           s_min: float = 0.55,
                           threshold: float = 0.5) -> np.ndarray:
    """Binary spike trains of a ``(N, T)`` batch as float32: per trace
    :func:`oasis_ar1`, then ``s > threshold``."""
    signals = np.asarray(signals)
    assert signals.ndim == 2
    out = np.zeros(signals.shape, dtype=np.float32)
    for i in range(signals.shape[0]):
        _, s = oasis_ar1(signals[i], g=g, s_min=s_min)
        out[i] = (s > threshold).astype(np.float32)
    return out


def golden_spikes(traces: np.ndarray, g: float = 0.95, s_min: float = 0.55,
                  threshold: float = 0.5) -> np.ndarray:
    """Binary float64 OASIS spikes of ``(N, T)`` host traces as ``np.int8``."""
    return deconvolve_signals_ref(
        np.asarray(traces, np.float64), g=g, s_min=s_min,
        threshold=threshold).astype(np.int8)
