"""Host-side dispatch of OASIS AR(1) spike deconvolution (counterpart of
``calciumgan_tpu/ops/oasis.py:179-398,401-430``).

:func:`deconvolve_signals_host` runs the OASIS kernel with the JAX
package's production arguments, walks a stack-depth ladder while too many
traces overflow, and recomputes every flagged trace exactly in float64 on
the host (the port's copy of the JAX package's C++ OASIS, compiled at
first use: :func:`host_library`). Traces of up to ``_PALLAS_MAX_T`` frames take
:func:`calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1` with the classic
machine and ``_DEPTH_LADDER``; longer ones (whole recordings) take
:func:`~calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1_long` with the precise
machine and the T-scaled ``_long_ladder``. Either runs the CUDA kernel for a
CUDA tensor and its plain PyTorch twin for a CPU tensor. The constants are
the JAX package's, with the reasons given there: they were measured for the
algorithm and its float32 arithmetic, which the port keeps. Throughput
figures in the JAX comments were taken on a TPU and say nothing of the GPU.

:func:`ar1_filter` is the forward model, spikes -> calcium, of the DG data
generators (counterpart of ``calciumgan_tpu/ops/oasis.py:451-491``): plain
PyTorch operations, as it is XLA and no kernel in the JAX package.

Not ported yet: the in-graph ``deconvolve_signals`` and its XLA
``while_loop`` machine ``oasis_ar1_jax``.
"""

from __future__ import annotations

import collections
import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter

import numpy as np
import torch

from calciumgan_tpu_torch.kernels import build
from calciumgan_tpu_torch.ops import oasis_cuda
from calciumgan_tpu_torch.ops.spike_metrics import first_order_recurrence

__all__ = ["ar1_filter", "deconvolve_signals_host"]

# first rung covers spiky-calcium sl2048 traces; escalate the whole batch
# one rung deeper while more than _ESCALATE_FRAC of its traces overflow
# (redo bit 0) — JAX ops/oasis.py:179-194
_DEPTH_LADDER = (64, 160, 256)
_ESCALATE_FRAC = 0.10

# fixed merge attempts per timestep; traces that need more are flagged
# (bit 1) and recomputed on the host — JAX ops/oasis.py:196-207
_MERGE_BUDGET = 2

# relative width of the borderline band around each float32 merge
# decision (bit 2), 10x the largest f32 margin error measured against f64
# — JAX ops/oasis.py:209-216
_BORDERLINE_TOL = 1e-5

# band of the precise machine (compensated v, closed-form w, split-argument
# g^l), 4.5x the largest margin error measured against f64 over 15.3M
# replayed decisions at 20k frames (3.36e-7) — JAX ops/oasis.py:218-228
_BORDERLINE_TOL_PRECISE = 1.5e-6

# longest trace the whole-trace TPU kernel holds in VMEM; longer recordings
# take the long kernel with the precise machine and the T-scaled ladder —
# JAX ops/oasis.py:250-260 (its _LONG_CHUNK sizes VMEM windows and has no
# counterpart here)
_PALLAS_MAX_T = oasis_cuda.PALLAS_MAX_T

# fewest flagged traces worth a thread of the host redo
_HOST_ROWS_PER_THREAD = 256


def _flag_tol(s_min: float, threshold: float,
              precise: bool = False) -> float:
    """Borderline band for ``(s_min, threshold)``: off only at ``s_min ==
    0``, where a flipped decision reconstructs the identical trace (JAX
    ``ops/oasis.py:231-248``); the precise machine's band is tighter."""
    del threshold
    if s_min <= 0.0:
        return 0.0
    return _BORDERLINE_TOL_PRECISE if precise else _BORDERLINE_TOL


def _long_ladder(T: int) -> tuple:
    """Depth ladder for whole recordings, scaled to T (JAX
    ``ops/oasis.py:264-285``): the final pool count grows with T (about the
    spike count; mean 403 / max 439 measured at 20k frames), so the first
    rung is 2.3% of T, 64-row aligned and at least 256 (512 at 20k frames),
    then it doubles; every rung is capped at T and at 2048 rows, and lanes
    deeper than the last rung go to the host redo."""
    r1 = max(256, -(-int(0.023 * T) // 64) * 64)
    return tuple(dict.fromkeys(
        min(T, d, 2048) for d in (r1, 2 * r1, max(4 * r1, 1024))))


def deconvolve_signals_host(signals, g: float = 0.95, s_min: float = 0.55,
                            threshold: float = 0.5,
                            depth: int | None = None,
                            stats: collections.Counter | None = None
                            ) -> np.ndarray:
    """Binary spikes of ``(..., T)`` traces as a host ``np.int8`` array of
    the same shape, equal to the float64 golden model's.

    ``signals``: a float32 tensor on the CPU or a CUDA device (the kernel
    runs where it lies), or a numpy array (taken as a CPU tensor).
    ``depth=None`` walks ``_DEPTH_LADDER``, or ``_long_ladder(T)`` for
    traces longer than ``_PALLAS_MAX_T``; an explicit ``depth`` pins one
    dispatch. Long traces on the CPU go straight to the exact host kernel,
    as the JAX package's do off the TPU (JAX ``ops/oasis.py:322-327``).

    A caller that reports where the time went passes a ``stats`` counter;
    the kernel route adds to it the host-clock seconds of ``kernel``
    (launch until the flags are on the host), ``spikes_to_host`` and
    ``redo``, ``kernel_device`` seconds by CUDA events, and the counts of
    ``traces`` dispatched, ``flagged``, and flagged by ``bit0`` (depth),
    ``bit1`` (merge budget) and ``bit2`` (borderline)."""
    if isinstance(signals, np.ndarray):
        signals = torch.from_numpy(np.ascontiguousarray(signals, np.float32))
    signals = signals.float().contiguous()
    T = signals.shape[-1]
    flat = signals.reshape(-1, T)
    long = T > _PALLAS_MAX_T
    if long and not signals.is_cuda:
        exact = _exact_spikes_host(flat.numpy(), g, s_min, threshold)
        return exact.reshape(signals.shape)
    if depth is not None:
        ladder = (depth,)
    elif long:
        ladder = _long_ladder(T)
    else:  # clamp to T and dedupe so short traces run one rung
        ladder = tuple(dict.fromkeys(min(T, d) for d in _DEPTH_LADDER))
    # long traces: the long kernel with the precise machine and its band
    # (JAX ops/oasis.py:369-398)
    entry = oasis_cuda.oasis_ar1_long if long else oasis_cuda.oasis_ar1
    spikes = _ladder_spikes(flat, ladder, entry, long, g, s_min, threshold,
                            stats)
    return spikes.reshape(signals.shape)


def _ladder_spikes(flat: torch.Tensor, ladder, entry, precise: bool,
                   g: float, s_min: float, threshold: float,
                   stats: collections.Counter | None = None) -> np.ndarray:
    """Host ``np.int8`` spikes of ``(N, T)`` traces: the kernel ``entry``
    (``oasis_cuda.oasis_ar1`` or ``oasis_ar1_long``) with the production
    merge budget and the band of the ``precise`` or classic machine, on
    each rung of ``ladder`` while more than ``_ESCALATE_FRAC`` of the
    traces overflow, then every flagged trace recomputed in float64 on the
    host (JAX ``ops/oasis.py:343-366``). ``stats`` takes the seconds and
    counts that :func:`deconvolve_signals_host` documents."""
    stats = collections.Counter() if stats is None else stats
    clock = perf_counter()

    def lap(stage: str) -> None:
        nonlocal clock
        now = perf_counter()
        stats[stage] += now - clock
        clock = now

    for i, d in enumerate(ladder):
        if flat.is_cuda:
            begin, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            begin.record()
        _, s, redo = entry(flat, g=g, lam=0.0, s_min=s_min, depth=d,
                           merge_attempts=_MERGE_BUDGET, precise=precise,
                           flag_tol=_flag_tol(s_min, threshold, precise))
        if flat.is_cuda:
            end.record()
        flags = redo.reshape(-1).cpu().numpy()  # waits for the kernel
        lap("kernel")
        if flat.is_cuda:
            stats["kernel_device"] += begin.elapsed_time(end) * 1e-3
        # escalate only on DEPTH flags (bit 0): a deeper stack cannot help
        # an exhausted merge budget (bit 1) or a borderline decision (bit 2)
        depth_frac = float(((flags & 1) != 0).mean()) if flags.size else 0.0
        if depth_frac <= _ESCALATE_FRAC or i == len(ladder) - 1:
            break
    spikes = (s > threshold).to(torch.int8).cpu().numpy()
    lap("spikes_to_host")
    stats.update(traces=flags.size, flagged=int((flags != 0).sum()),
                 **{f"bit{b}": int(((flags >> b) & 1).sum())
                    for b in range(3)})
    if flags.any():
        idx = np.nonzero(flags)[0]
        rows = flat[torch.from_numpy(idx).to(flat.device)].cpu().numpy()
        spikes[idx] = _exact_spikes_host(rows, g, s_min, threshold)
        lap("redo")
    return spikes


def host_library() -> build.Built:
    """The C++ float64 OASIS ``csrc/oasis_host.cc`` (the port's copy of the
    JAX package's, ``calciumgan_tpu/native/calciumgan_native.cc``), built
    by :func:`calciumgan_tpu_torch.kernels.build.load_host` without OpenMP:
    a GPU host may lack libgomp."""
    built = build.load_host("oasis_host", build.CSRC / "oasis_host.cc")
    fn = built.lib.cg_deconvolve_batch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_double, ctypes.c_double, ctypes.c_double,
                   ctypes.c_void_p]
    fn.restype = None
    return built


def _exact_spikes_host(traces: np.ndarray, g: float, s_min: float,
                       threshold: float) -> np.ndarray:
    """Exact float64 spikes of ``(N, T)`` traces, as ``np.int8``: the C++
    kernel of :func:`host_library` on up to one thread per core
    (``ctypes`` releases the GIL). It leaves float32 behind, which a trace
    flagged as borderline needs (JAX ``ops/oasis.py:401-427``). Raises
    ``RuntimeError`` when the library cannot be built."""
    traces = np.ascontiguousarray(traces, np.float32)
    fn = host_library().lib.cg_deconvolve_batch
    n, T = traces.shape
    out = np.empty((n, T), np.float32)

    def rows(lo: int, hi: int) -> None:
        fn(traces[lo:].ctypes.data, hi - lo, T, g, s_min, threshold,
           out[lo:].ctypes.data)

    workers = max(1, min(len(os.sched_getaffinity(0)),
                         n // _HOST_ROWS_PER_THREAD))
    bounds = np.linspace(0, n, workers + 1).astype(int)
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(rows, bounds[:-1], bounds[1:]))
    return out.astype(np.int8)


def ar1_filter(spikes, g=(0.95,), axis: int = -1) -> torch.Tensor:
    """Spikes -> calcium via the AR recurrence, where ``spikes`` lies (a
    tensor, or an array taken as a CPU tensor).

    AR(1): ``c[t] = s[t] + g*c[t-1]`` for ``t >= 2`` with ``c[0] = s[0]``,
    ``c[1] = s[1]``: the DG generators start the recurrence at t = 2, so the
    ``g*c[0]`` term is absent at t = 1, which is reproduced by subtracting
    ``g*s[0]`` from ``s[1]`` before the full recurrence runs as a log-depth
    scan (:func:`~calciumgan_tpu_torch.ops.spike_metrics.
    first_order_recurrence`). The JAX package's ``lax.associative_scan``
    combines in another tree, so the two agree to float32 rounding, not bit
    for bit. AR(2), ``g = (g1, g2)``, is a sequential loop that passes the
    first two samples through unchanged."""
    spikes = torch.as_tensor(spikes)
    if not spikes.is_floating_point():
        # int/bool spike trains (e.g. the int8 `spikes` datasets) would
        # truncate g to 0 in the affine maps and silently skip the decay
        spikes = spikes.to(torch.float32)
    g = tuple(float(x) for x in (g if hasattr(g, "__len__") else (g,)))
    x = torch.movedim(spikes, axis, -1)

    if len(g) == 1:
        if x.shape[-1] >= 2:
            x = torch.cat([x[..., :1],
                           (x[..., 1] + (-g[0]) * x[..., 0])[..., None],
                           x[..., 2:]], dim=-1)
        _, c = first_order_recurrence(torch.full_like(x, g[0]), x, axis=-1)
    else:
        g1, g2 = g
        # reference semantics: the first two samples pass through unchanged
        frames = list(x[..., :2].unbind(-1))
        for s_t in x[..., 2:].unbind(-1):
            frames.append(s_t + g1 * frames[-1] + g2 * frames[-2])
        c = torch.stack(frames, dim=-1)

    return torch.movedim(c, -1, axis)
