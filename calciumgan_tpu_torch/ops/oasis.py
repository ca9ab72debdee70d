"""Host-side dispatch of OASIS AR(1) spike deconvolution (counterpart of
``calciumgan_tpu/ops/oasis.py:179-398,401-430``).

:func:`deconvolve_signals_host` runs the OASIS kernel with the JAX
package's production arguments, walks a stack-depth ladder while too many
traces overflow, and recomputes every flagged trace exactly in float64 on
the host (the JAX package's C++ OASIS, compiled by the port:
:func:`host_library`). Traces of up to ``_PALLAS_MAX_T`` frames take
:func:`calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1` with the classic
machine and ``_DEPTH_LADDER``; longer ones (whole recordings) take
:func:`~calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1_long` with the precise
machine and the T-scaled ``_long_ladder``. Either runs the CUDA kernel for a
CUDA tensor and its plain PyTorch twin for a CPU tensor. The constants are
the JAX package's, with the reasons given there: they were measured for the
algorithm and its float32 arithmetic, which the port keeps. Throughput
figures in the JAX comments were taken on a TPU and say nothing of the GPU.

Not ported yet: the in-graph ``deconvolve_signals`` and its XLA
``while_loop`` machine ``oasis_ar1_jax``.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from calciumgan_tpu_torch.kernels import build
from calciumgan_tpu_torch.ops import oasis_cuda

__all__ = ["deconvolve_signals_host"]

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
                            depth: int | None = None) -> np.ndarray:
    """Binary spikes of ``(..., T)`` traces as a host ``np.int8`` array of
    the same shape, equal to the float64 golden model's.

    ``signals``: a float32 tensor on the CPU or a CUDA device (the kernel
    runs where it lies), or a numpy array (taken as a CPU tensor).
    ``depth=None`` walks ``_DEPTH_LADDER``, or ``_long_ladder(T)`` for
    traces longer than ``_PALLAS_MAX_T``; an explicit ``depth`` pins one
    dispatch. Long traces on the CPU go straight to the exact host kernel,
    as the JAX package's do off the TPU (JAX ``ops/oasis.py:322-327``)."""
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
    spikes = _ladder_spikes(flat, ladder, entry, long, g, s_min, threshold)
    return spikes.reshape(signals.shape)


def _ladder_spikes(flat: torch.Tensor, ladder, entry, precise: bool,
                   g: float, s_min: float, threshold: float) -> np.ndarray:
    """Host ``np.int8`` spikes of ``(N, T)`` traces: the kernel ``entry``
    (``oasis_cuda.oasis_ar1`` or ``oasis_ar1_long``) with the production
    merge budget and the band of the ``precise`` or classic machine, on
    each rung of ``ladder`` while more than ``_ESCALATE_FRAC`` of the
    traces overflow, then every flagged trace recomputed in float64 on the
    host (JAX ``ops/oasis.py:343-366``)."""
    for i, d in enumerate(ladder):
        _, s, redo = entry(flat, g=g, lam=0.0, s_min=s_min, depth=d,
                           merge_attempts=_MERGE_BUDGET, precise=precise,
                           flag_tol=_flag_tol(s_min, threshold, precise))
        flags = redo.reshape(-1).cpu().numpy()
        # escalate only on DEPTH flags (bit 0): a deeper stack cannot help
        # an exhausted merge budget (bit 1) or a borderline decision (bit 2)
        depth_frac = float(((flags & 1) != 0).mean()) if flags.size else 0.0
        if depth_frac <= _ESCALATE_FRAC or i == len(ladder) - 1:
            break
    spikes = (s > threshold).to(torch.int8).cpu().numpy()
    if flags.any():
        idx = np.nonzero(flags)[0]
        rows = flat[torch.from_numpy(idx).to(flat.device)].cpu().numpy()
        spikes[idx] = _exact_spikes_host(rows, g, s_min, threshold)
    return spikes


def host_library() -> build.Built:
    """The JAX package's C++ float64 OASIS
    (``calciumgan_tpu/native/calciumgan_native.cc``), built by
    :func:`calciumgan_tpu_torch.kernels.build.load_host` without OpenMP: a
    GPU host may lack libgomp, which fails ``calciumgan_tpu.native``'s own
    ``make``."""
    from calciumgan_tpu import native
    built = build.load_host(
        "calciumgan_native",
        Path(native.__file__).with_name("calciumgan_native.cc"))
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
