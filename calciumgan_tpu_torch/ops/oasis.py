"""OASIS AR(1) spike deconvolution: the host-side dispatch, the in-graph
API and the AR(1) forward model (counterpart of
``calciumgan_tpu/ops/oasis.py``).

:func:`deconvolve_signals_host` runs the OASIS kernel with the JAX
package's production arguments, walks a stack-depth ladder while too many
traces overflow, and recomputes every flagged trace exactly in float64: on
the card for CUDA traces (:func:`~calciumgan_tpu_torch.ops.oasis_cuda.
oasis_exact_f64`), on the host for CPU ones (the port's copy of the JAX
package's C++ OASIS, compiled at first use: :func:`host_library`); the two
give the same spikes bit for bit. Every rung runs
:func:`calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1`, the CUDA kernel for a
CUDA tensor and its plain PyTorch twin for a CPU tensor: traces of up to
``_PALLAS_MAX_T`` frames with the classic machine and ``_DEPTH_LADDER``,
longer ones (whole recordings) with the precise machine and the T-scaled
``_long_ladder``. The constants are the JAX package's, with the reasons
given there: they were measured for the algorithm and its float32
arithmetic, which the port keeps. Throughput figures in the JAX comments
were taken on a TPU and say nothing of the GPU.

:func:`ar1_filter` is the forward model, spikes -> calcium, of the DG data
generators (counterpart of ``calciumgan_tpu/ops/oasis.py:451-491``): plain
PyTorch operations, as it is XLA and no kernel in the JAX package.

:func:`deconvolve_signals` is the in-graph API (JAX ``:124-177``): float32
spikes that stay on the traces' device. Its ``"kernel"`` backend (JAX's
``"pallas"``) runs :func:`~calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1`
with JAX's arguments and gives every flagged row the spikes of
:func:`oasis_ar1_while`, the float32 pool machine of ``oasis_ar1_jax``
(JAX ``:37-121``: an XLA ``while_loop``, so plain PyTorch operations
here), run on those rows alone; JAX reruns the whole batch when one lane
flags, which gives each row the same result.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from calciumgan_tpu_torch.kernels import build
from calciumgan_tpu_torch.ops import oasis_cuda
from calciumgan_tpu_torch.ops.spike_metrics import first_order_recurrence
from calciumgan_tpu_torch.utils import crossing, tracing

__all__ = ["ar1_filter", "deconvolve_signals", "deconvolve_signals_host",
           "oasis_ar1_while"]

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

# the in-graph API's merge budget: oasis_ar1_pallas's default, which the
# JAX package's deconvolve_signals keeps
_IN_GRAPH_MERGE_ATTEMPTS = 4

# iterations of oasis_ar1_while between two looks (a device sync) at
# whether a lane is still active; the iterations after the last lane ends
# change nothing
_WHILE_CHECK_EVERY = 64


def oasis_ar1_while(signals, g: float = 0.95, lam: float = 0.0,
                    s_min: float = 0.0):
    """OASIS AR(1) of ``(..., T)`` traces by the pool machine of the JAX
    package's ``oasis_ar1_jax`` / ``_oasis_single`` (JAX ``ops/oasis.py:
    37-121``), on the traces' device; returns ``(c, s)`` of their shape.

    float32 throughout, in JAX's order of operations: ``g^e`` is
    ``exp(e * log g)``. Each lane holds pools ``v``, ``w``, ``ln`` of shape
    ``(B, T)``, its frame ``t`` and top pool ``p``; an iteration merges the
    top pool into its neighbour where it violates the ordering and pushes
    the next frame otherwise, until no lane is active (at most ``2T - 2``
    iterations). The pools are then spread over the frames in parallel
    (``cumsum`` of the pool lengths, ``searchsorted``). Lanes are
    independent: a subset of rows gives those rows' results."""
    signals = torch.as_tensor(signals, dtype=torch.float32)
    T = signals.shape[-1]
    if T < 1:
        raise ValueError(f"signals must be (..., T) with T >= 1, got shape "
                         f"{tuple(signals.shape)}")
    y = signals.reshape(-1, T)
    B, dev, f32 = y.shape[0], y.device, torch.float32
    g32 = torch.tensor(g, dtype=f32, device=dev)
    log_g = torch.log(g32)
    s_min32 = torch.tensor(s_min, dtype=f32, device=dev)
    lam32 = torch.tensor(lam, dtype=f32, device=dev)
    yy = y - lam32 * (1.0 - g32)
    yy[:, -1] = y[:, -1] - lam32

    v = torch.zeros((B, T), dtype=f32, device=dev)
    w = torch.zeros_like(v)
    ln = torch.zeros((B, T), dtype=torch.int32, device=dev)
    v[:, 0], w[:, 0], ln[:, 0] = yy[:, 0], 1.0, 1
    t = torch.ones(B, dtype=torch.long, device=dev)
    p = torch.zeros(B, dtype=torch.long, device=dev)
    base = torch.arange(B, device=dev) * T   # lane b's slots: base[b] + i
    vf, wf, lf, yf = v.view(-1), w.view(-1), ln.view(-1), yy.reshape(-1)
    for it in range(2 * T):
        at_p, at_q = base + p, base + (p - 1).clamp_min(0)
        vp, wp, lp = vf[at_p], wf[at_p], lf[at_p]
        vq, wq, lq = vf[at_q], wf[at_q], lf[at_q]
        gl = torch.exp(lq.to(f32) * log_g)
        viol = (p > 0) & (vp / wp < gl * (vq / wq) + s_min32)
        active = viol | (t < T)
        if it % _WHILE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        push = active & ~viol
        # one slot changes a lane: the merge's neighbour, the push's new
        # pool, or (inactive) the top pool rewritten with its own values
        at = torch.where(viol, at_q, torch.where(
            push, base + (p + 1).clamp_max(T - 1), at_p))
        y_t = yf[base + t.clamp_max(T - 1)]
        vf[at] = torch.where(viol, vq + gl * vp, torch.where(push, y_t, vp))
        wf[at] = torch.where(viol, wq + gl * gl * wp,
                             torch.where(push, 1.0, wp))
        lf[at] = torch.where(viol, lq + lp, torch.where(push, 1, lp))
        t = t + push
        p = p + push.long() - viol.long()

    # parallel reconstruction (JAX ops/oasis.py:96-110)
    idx = torch.arange(T, device=dev)
    valid = idx < (p + 1)[:, None]
    l_masked = torch.where(valid, ln.long(), 0)
    starts = torch.cumsum(l_masked, 1) - l_masked
    starts = torch.where(valid, starts, T)  # empty pools start after T
    pool_id = torch.searchsorted(starts, idx.expand(B, T).contiguous(),
                                 right=True) - 1
    h = torch.clamp_min(v / w, 0.0)
    c = h.gather(1, pool_id) * torch.exp(
        (idx - starts.gather(1, pool_id)).to(f32) * log_g)
    s = torch.cat([torch.zeros_like(c[:, :1]), c[:, 1:] - g32 * c[:, :-1]],
                  dim=1)
    return c.reshape(signals.shape), s.reshape(signals.shape)


def _in_graph_backend(backend: str, signals) -> str:
    """``"kernel"`` or ``"while"``: ``"auto"`` takes the kernel for a CUDA
    tensor of up to ``_PALLAS_MAX_T`` frames, as the JAX package takes
    Pallas on a TPU, and the while machine otherwise."""
    if backend == "auto":
        return ("kernel" if signals.is_cuda
                and signals.shape[-1] <= _PALLAS_MAX_T else "while")
    if backend not in ("kernel", "while"):
        raise ValueError(f"backend must be 'auto', 'kernel' or 'while', "
                         f"got {backend!r}")
    return backend


def deconvolve_signals(signals, g: float = 0.95, s_min: float = 0.55,
                       threshold: float = 0.5, backend: str = "auto",
                       depth: int | None = None) -> torch.Tensor:
    """Binary spike trains of ``(..., T)`` traces as float32 of the same
    shape on the same device (JAX ``ops/oasis.py:124-177``; the
    reference's recipe g 0.95, s_min 0.55, binarised at 0.5).

    ``backend``: ``"kernel"`` (the port's name for JAX's ``"pallas"``) runs
    :func:`~calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1` (the CUDA kernel
    for a CUDA tensor, its plain twin for a CPU one) with JAX's arguments
    (``lam`` 0, ``depth``, merge budget 4, no borderline band, so redo bit
    2 never rises), then gives every flagged row the spikes of
    :func:`oasis_ar1_while` run on the flagged rows alone; ``"while"``
    runs :func:`oasis_ar1_while` on every row; ``"auto"`` takes the kernel
    for a CUDA tensor of up to ``_PALLAS_MAX_T`` frames and the while
    machine otherwise. The traces stay on their device; the kernel backend
    syncs once, to learn which rows flagged.

    Precision: exact with respect to the float32 algorithm, as JAX's; a
    decision whose float32 margin is within rounding may differ from the
    float64 golden. :func:`deconvolve_signals_host` recomputes such rows
    in float64."""
    signals = torch.as_tensor(signals, dtype=torch.float32)
    if _in_graph_backend(backend, signals) == "while":
        _, s = oasis_ar1_while(signals, g=g, s_min=s_min)
    else:
        flat = signals.reshape(-1, signals.shape[-1]).contiguous()
        _, s, redo = oasis_cuda.oasis_ar1(
            flat, g=g, lam=0.0, s_min=s_min, depth=depth,
            merge_attempts=_IN_GRAPH_MERGE_ATTEMPTS, flag_tol=0.0)
        rows = torch.nonzero(redo).squeeze(1)
        if rows.numel():
            s[rows] = oasis_ar1_while(flat[rows], g=g, s_min=s_min)[1]
        s = s.reshape(signals.shape)
    return (s > threshold).to(torch.float32)


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
    as the JAX package's do off the TPU (JAX ``ops/oasis.py:322-327``).

    Flagged traces are redone in float64 where the traces lie: on the card
    for a CUDA tensor, with the C++ kernel on the host for a CPU one.

    The spikes take the shape and the strides of ``signals`` wherever its
    elements fill one dense block, on either device and on either route: a
    contiguous tensor gives contiguous spikes, a permuted view (such as
    generate's ``(n, C, T)`` view of ``(n, T, C)`` signals) spikes laid out
    as the tensor it views. They are laid out so where the traces lie and
    handed to the host once (:mod:`~calciumgan_tpu_torch.utils.crossing`:
    from the card by DMA into page-locked memory), an array the caller
    owns.

    The kernel route runs as the spans ``oasis/kernel`` (launch until the
    flags are on the host, one a rung, args: the depth), ``oasis/redo``
    (args: the rows; on the card it ends when the redo has) and then
    ``oasis/spikes_to_host``, and counts ``oasis/traces`` dispatched,
    ``oasis/flagged``, and flagged by ``oasis/bit0`` (depth), ``bit1``
    (merge budget) and ``bit2`` (borderline), and ``oasis/window_moves``,
    the ring slots the kernel moved between its windows and its rings over
    every rung (read with each rung's flags; 0 on the CPU)
    (:mod:`~calciumgan_tpu_torch.utils.tracing`)."""
    if isinstance(signals, np.ndarray):
        signals = torch.from_numpy(np.ascontiguousarray(signals, np.float32))
    like = signals  # the spikes land in its strides
    T = signals.shape[-1]
    flat = signals.float().contiguous().reshape(-1, T)
    long = T > _PALLAS_MAX_T
    if long and not flat.is_cuda:
        exact = _exact_spikes_host(flat.numpy(), g, s_min, threshold)
        return _laid_out(torch.from_numpy(exact), like).numpy()
    if depth is not None:
        ladder = (depth,)
    elif long:
        ladder = _long_ladder(T)
    else:  # clamp to T and dedupe so short traces run one rung
        ladder = tuple(dict.fromkeys(min(T, d) for d in _DEPTH_LADDER))
    # long traces: the precise machine and its band (JAX ops/oasis.py:
    # 369-398)
    return _ladder_spikes(flat, ladder, long, g, s_min, threshold, like)


def _laid_out(spikes: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``spikes`` (int8, ``like``'s elements in any layout) copied into
    ``like``'s shape and strides, where ``spikes`` lies."""
    laid = torch.empty_like(like, dtype=torch.int8)
    laid.copy_(spikes.reshape(like.shape))
    return laid


def _ladder_spikes(flat: torch.Tensor, ladder, precise: bool,
                   g: float, s_min: float, threshold: float,
                   like: torch.Tensor | None = None) -> np.ndarray:
    """Host ``np.int8`` spikes of ``(N, T)`` traces, of the shape and the
    strides of ``like`` (default ``flat``; its elements are those traces):
    :func:`~calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1` with the
    production merge budget and the band of the ``precise`` or classic
    machine, on each rung of ``ladder`` while more than ``_ESCALATE_FRAC``
    of the traces overflow; then, where the traces lie, every flagged trace
    recomputed in float64 (JAX ``ops/oasis.py:343-366``; on the card by
    :func:`~calciumgan_tpu_torch.ops.oasis_cuda.oasis_exact_f64`, on the
    host by :func:`_exact_spikes_host`) and the spikes laid out in
    ``like``'s strides; last, one crossing to the host."""
    like = flat if like is None else like
    moves = torch.empty(flat.shape[0], dtype=torch.int32, device=flat.device)
    window_moves = 0
    for i, d in enumerate(ladder):
        with tracing.span("oasis/kernel", depth=d):
            _, s, redo = oasis_cuda.oasis_ar1(
                flat, g=g, lam=0.0, s_min=s_min, depth=d,
                merge_attempts=_MERGE_BUDGET, precise=precise,
                flag_tol=_flag_tol(s_min, threshold, precise), moves=moves)
            # the flags and the moves' int64 sum (as two int32 words) in
            # one readout, which waits for the kernel
            total = moves.sum(dtype=torch.int64).reshape(1)
            readout = torch.cat((redo.reshape(-1), total.view(torch.int32)))
            readout = readout.cpu().numpy()
        flags = readout[:-2]
        window_moves += int(readout[-2:].view(np.int64)[0])
        # escalate only on DEPTH flags (bit 0): a deeper stack cannot help
        # an exhausted merge budget (bit 1) or a borderline decision (bit 2)
        depth_frac = float(((flags & 1) != 0).mean()) if flags.size else 0.0
        if depth_frac <= _ESCALATE_FRAC or i == len(ladder) - 1:
            break
    tracing.count("oasis", traces=flags.size,
                  flagged=int((flags != 0).sum()),
                  **{f"bit{b}": int(((flags >> b) & 1).sum())
                     for b in range(3)}, window_moves=window_moves)
    spikes = (s > threshold).to(torch.int8)
    idx = np.nonzero(flags)[0]
    if idx.size:
        with tracing.span("oasis/redo", rows=idx.size):
            rows = torch.from_numpy(idx)
            if flat.is_cuda:
                oasis_cuda.oasis_exact_f64(flat, rows.to(flat.device),
                                           spikes, g, s_min, threshold)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
            else:
                spikes[rows] = torch.from_numpy(_exact_spikes_host(
                    flat.numpy()[idx], g, s_min, threshold))
    with tracing.span("oasis/spikes_to_host"):
        return crossing.to_host(_laid_out(spikes, like))


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
