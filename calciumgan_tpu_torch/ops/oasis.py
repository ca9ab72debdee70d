"""Host-side dispatch of OASIS AR(1) spike deconvolution (counterpart of
``calciumgan_tpu/ops/oasis.py:179-260,288-380,401-430``).

:func:`deconvolve_signals_host` runs the OASIS kernel
(:func:`calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1`: the CUDA kernel for
a CUDA tensor, its plain PyTorch twin for a CPU tensor) with the JAX
package's production arguments, walks the stack-depth ladder while too many
traces overflow, and recomputes every flagged trace exactly in float64 on
the host (the JAX package's C++ OASIS, compiled by the port:
:func:`host_library`). The constants are the JAX package's, with the reasons given there:
they were measured for the algorithm and its float32 arithmetic, which the
port keeps. Throughput figures in the JAX comments were taken on a TPU and
say nothing of the GPU.

Not ported yet: traces longer than ``_PALLAS_MAX_T`` on the GPU (the
time-chunked ``oasis_ar1_pallas_long`` with its precise machine and
T-scaled ladder) and the in-graph ``deconvolve_signals``.
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

# longest trace of the whole-trace kernel; longer recordings took the
# time-chunked TPU kernel, which is not ported yet — JAX ops/oasis.py:250-260
_PALLAS_MAX_T = 4096

# fewest flagged traces worth a thread of the host redo
_HOST_ROWS_PER_THREAD = 256


def _flag_tol(s_min: float, threshold: float) -> float:
    """Borderline band for ``(s_min, threshold)``: off only at ``s_min ==
    0``, where a flipped decision reconstructs the identical trace (JAX
    ``ops/oasis.py:231-248``)."""
    del threshold
    return 0.0 if s_min <= 0.0 else _BORDERLINE_TOL


def deconvolve_signals_host(signals, g: float = 0.95, s_min: float = 0.55,
                            threshold: float = 0.5,
                            depth: int | None = None) -> np.ndarray:
    """Binary spikes of ``(..., T)`` traces as a host ``np.int8`` array of
    the same shape, equal to the float64 golden model's.

    ``signals``: a float32 tensor on the CPU or a CUDA device (the kernel
    runs where it lies), or a numpy array (taken as a CPU tensor).
    ``depth=None`` walks ``_DEPTH_LADDER``; an explicit ``depth`` pins one
    dispatch."""
    if isinstance(signals, np.ndarray):
        signals = torch.from_numpy(np.ascontiguousarray(signals, np.float32))
    signals = signals.float().contiguous()
    T = signals.shape[-1]
    flat = signals.reshape(-1, T)
    if T > _PALLAS_MAX_T:
        if signals.is_cuda:
            raise NotImplementedError(
                f"traces of {T} > {_PALLAS_MAX_T} frames need the "
                "time-chunked kernel oasis_ar1_pallas_long, not ported yet "
                "(ROADMAP, still to port)")
        exact = _exact_spikes_host(flat.numpy(), g, s_min, threshold)
        return exact.reshape(signals.shape)
    if depth is not None:
        ladder = (depth,)
    else:  # clamp to T and dedupe so short traces run one rung
        ladder = tuple(dict.fromkeys(min(T, d) for d in _DEPTH_LADDER))
    for i, d in enumerate(ladder):
        _, s, redo = oasis_cuda.oasis_ar1(
            signals, g=g, lam=0.0, s_min=s_min, depth=d,
            merge_attempts=_MERGE_BUDGET, flag_tol=_flag_tol(s_min, threshold))
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
        spikes.reshape(-1, T)[idx] = _exact_spikes_host(rows, g, s_min,
                                                        threshold)
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
