"""OASIS AR(1) on the GPU: the wrappers of the hand-written Hopper kernel
``csrc/oasis_ar1.cu`` and the device dispatch.

The kernel replaces both Pallas TPU kernels of
``calciumgan_tpu/ops/oasis_pallas.py``, each with the classic or the precise
stack machine:

- :func:`oasis_ar1` replaces ``oasis_ar1_pallas`` (``:603-672``);
- :func:`oasis_ar1_long` replaces the time-chunked ``oasis_ar1_pallas_long``
  (``:513-596``), for recordings of any length.

Both keep the TPU kernels' signatures ``(signals, g, lam, s_min, depth,
merge_attempts, flag_tol, precise) -> (c, s, redo)`` and redo bitmask (see
:mod:`.oasis_torch`, their plain PyTorch twin, for the contract). The
wrapper keeps the TPU kernel's time-major ``(T, B)`` layout so that each
timestep's load across a warp is coalesced, applies the ``lam`` shift, and
allocates the outputs and, for a windowed ring, the ``(3, D, B)`` stack
scratch; the kernel allocates nothing and does not synchronise.

Where each trace's ring of ``D`` pool slots lives is a pure function of
the launch's ring depth, machine and traces and of the card's SM count,
:func:`launch_plan`, one warp of traces per block either way: the whole
ring in shared memory wherever it is no deeper than ``WINDOW`` slots (the
short ladder's first rung, D 64), or fits and every block of the launch is
resident at once (a whole 102 x 20,000 recording at D 512); else
a ``(3, D, B)`` device-memory scratch behind a window of its top
``WINDOW`` stack positions in shared memory (the served batches' deeper
rungs, every rung past 605 slots). A whole ring of D 384 takes 147,456 B
a warp, so one warp an SM: 16,320 traces of 16,384 frames ran in four
waves; the window takes the same bytes whatever D is, so they run in one,
at a slower frame (a fill or write-back from the device ring) than a
whole ring's where both take one wave. The window slides only when a
stack leaves it, and the kernel counts, for each trace, the slots it
moved between the window and the ring (``moves``).
There is no switch; a refused launch raises.

:func:`oasis_exact_f64` replaces no TPU kernel: it is the exact float64
redo of the traces those kernels flag, on the card (``oasis_exact_f64_kernel``
in the same source), where the JAX package runs it on the host. It computes
what the port's C++ ``cg_deconvolve_batch`` (``csrc/oasis_host.cc``)
computes, bit for bit, with ``g^l`` read from the host's own table
(:func:`pow_table`); its plain twin is :func:`oasis_exact_f64_torch`.

Each entry takes the plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches
by machine, trace length and ring storage, whichever entry made them:
``oasis_ar1`` and ``oasis_ar1_precise`` for traces of up to
``PALLAS_MAX_T`` frames, ``oasis_ar1_long`` and ``oasis_ar1_long_precise``
for longer ones, each with ``/shared`` or ``/window`` (e.g.
``oasis_ar1_long_precise/window``), and ``oasis_exact_f64/device`` for the
float64 redo (one a chunk of rows).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math

import numpy as np
import torch

from calciumgan_tpu_torch.kernels import build
from calciumgan_tpu_torch.ops import oasis_torch

launches: collections.Counter = collections.Counter()

# longest trace oasis_ar1_pallas holds in VMEM (JAX ops/oasis.py:250-260);
# beyond it the JAX package runs the long kernel
PALLAS_MAX_T = 4096

# dynamic shared memory one block may opt into on Hopper (sm_90), an SM's
# shared memory, and what the runtime reserves of it for each block
SHARED_BYTES_MAX = 232_448
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024
WARP = 32
# ring slots a trace keeps in shared memory behind a window over a deeper
# ring (a power of two), and the deepest ring taken whole whatever the
# launch's size. Measured on an H100 on the benchmark's served models
# (PERF.md §6): 32, 64 and 128 slots and 32, 64 and 128 lanes a block run
# 16,320 traces of 16,384 frames in the same time; 64 slots move 1.0% of
# the frames' slots (32: 1.1%) and leave 9 one-warp blocks an SM, so
# 104,448 traces of 2048 frames at D 160 or 256 take 9.1 ms (128 slots:
# 15.7; 128 lanes: 10.9)
WINDOW = 64
# the float32 fields of a ring slot, by machine (precise: the bfloat16-
# rounded compensation of v is kept widened to float32)
_RING_FIELDS = {False: ("v", "w", "l"), True: ("v", "ve", "l")}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    storage: str       # "shared" (the whole ring) or "window"
    lanes: int         # traces (threads) per block, a multiple of 32
    window: int        # ring slots a trace keeps in shared memory
    shared_bytes: int  # dynamic shared memory per block


def launch_plan(D: int, precise: bool, B: int, sms: int) -> LaunchPlan:
    """Where a launch of ``B`` traces with ``D``-slot rings on a card of
    ``sms`` SMs keeps them, laid out ``[field][slot][lane]`` in shared
    memory for one warp of traces per block.

    The whole ring, wherever it fits in a block and the launch's
    ``ceil(B / 32)`` blocks are all resident at once (every ring of up to
    ``WINDOW`` slots, whatever ``B``): a frame then reads shared memory
    alone. Else a ``(3, D, B)`` device-memory scratch
    (:func:`ring_scratch`) behind a window of ``WINDOW`` stack positions:
    24,576 B a block whatever D is, nine blocks an SM. A whole ring of D
    384 takes 147,456 B a block, so one block an SM: 16,320 traces take
    four waves of it and one of windows, while 102 traces take one wave
    either way, at a whole ring's faster frame."""
    slot_bytes = 4 * len(_RING_FIELDS[precise])
    whole = slot_bytes * D * WARP
    resident = sms * (SM_SHARED_BYTES // (whole + BLOCK_RESERVED_BYTES))
    if D <= WINDOW or (whole <= SHARED_BYTES_MAX
                       and -(-B // WARP) <= resident):
        return LaunchPlan("shared", WARP, D, whole)
    return LaunchPlan("window", WARP, WINDOW, slot_bytes * WINDOW * WARP)


def sm_count(device) -> int:
    """The streaming multiprocessors of ``device``'s card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ring_scratch(plan: LaunchPlan, D: int, B: int, device) -> torch.Tensor:
    """The device-memory rings of ``plan``: ``(3, D, B)`` float32 behind a
    window, an empty tensor for a whole ring (the kernel keeps it in shared
    memory and takes no scratch)."""
    if plan.storage == "shared":
        return torch.empty((0,), dtype=torch.float32, device=device)
    return torch.empty((3, D, B), dtype=torch.float32, device=device)


# the float64 redo: bytes of one ring slot (v and w as double, the length
# as int32), and the most its scratch takes at once; the rows go in chunks
# under it (a long evaluation chunk with nearly every row flagged would
# otherwise take 5.3 GB)
_EXACT_SLOT_BYTES = 20
_EXACT_SCRATCH_BYTES = 1 << 30
# g^l tables by (g, T, device): filled on the host by cg_pow_table
_pow_tables: dict = {}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_float])
_PLAN_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
_CLASSIC_ARGTYPES = _ARGTYPES + _PLAN_ARGTYPES
_PRECISE_ARGTYPES = _ARGTYPES + [ctypes.c_float] * 3 + _PLAN_ARGTYPES
_EXACT_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_double] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_void_p])


def library() -> build.Built:
    """The built kernel library (compiled by ``nvcc`` at first use)."""
    built = build.load("oasis_ar1")
    for name, argtypes in (("oasis_ar1_launch", _CLASSIC_ARGTYPES),
                           ("oasis_ar1_precise_launch", _PRECISE_ARGTYPES),
                           ("oasis_exact_f64_launch", _EXACT_ARGTYPES)):
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return built


def oasis_ar1(signals: torch.Tensor, g: float = 0.95, lam: float = 0.0,
              s_min: float = 0.0, depth: int | None = None,
              merge_attempts: int = 4, flag_tol: float = 0.0,
              precise: bool = False, moves: torch.Tensor | None = None):
    """OASIS AR(1) with the redo bitmask, on ``signals``' device: the CUDA
    kernel for a CUDA tensor, the plain PyTorch version for a CPU one.
    ``depth=None`` is ``min(T, 128)`` rows, as ``oasis_ar1_pallas``'s.
    ``moves``, an int32 tensor of the batch's shape on the same device,
    takes each trace's ring slots moved between its window and its ring:
    0 for a whole ring, and on the CPU, whose plain version has none."""
    args = (g, lam, s_min, depth, merge_attempts, flag_tol, precise)
    if signals.device.type == "cpu":
        if moves is not None:
            moves.zero_()
        return oasis_torch.oasis_ar1_torch(signals, *args)
    if signals.device.type == "cuda":
        return oasis_ar1_cuda(signals, *args, moves=moves)
    raise ValueError(f"no OASIS kernel for device {signals.device}")


def oasis_ar1_long(signals: torch.Tensor, g: float = 0.95, lam: float = 0.0,
                   s_min: float = 0.0, depth: int = 512,
                   merge_attempts: int = 4, flag_tol: float = 0.0,
                   precise: bool = False):
    """OASIS AR(1) for traces of any length, e.g. whole 20k-frame
    recordings: ``oasis_ar1_pallas_long``'s signature and defaults (a
    512-row stack) on ``signals``' device.

    It takes no ``chunk``. The TPU kernel walks time in 2048-frame chunks
    only because a whole ``(T, 128)`` window of a long trace does not fit
    in VMEM, and carries the pool stacks from chunk to chunk in scratch.
    On the GPU one thread walks a whole trace with its ring in shared or
    device memory (:func:`launch_plan`), so nothing has to be carried
    between grid steps and the whole-trace kernel serves any ``T``."""
    args = (g, lam, s_min, depth, merge_attempts, flag_tol, precise)
    if signals.device.type == "cpu":
        return oasis_torch.oasis_ar1_long_torch(signals, *args)
    if signals.device.type == "cuda":
        return oasis_ar1_cuda(signals, *args)
    raise ValueError(f"no OASIS kernel for device {signals.device}")


def oasis_ar1_cuda(signals: torch.Tensor, g: float = 0.95, lam: float = 0.0,
                   s_min: float = 0.0, depth: int | None = None,
                   merge_attempts: int = 4, flag_tol: float = 0.0,
                   precise: bool = False, moves: torch.Tensor | None = None):
    """Launch the kernel on ``(..., T)`` contiguous float32 CUDA traces,
    with the classic or the ``precise`` machine; ``moves`` as
    :func:`oasis_ar1` takes it."""
    if not signals.is_cuda:
        raise ValueError(f"signals must be a CUDA tensor, got "
                         f"{signals.device}")
    if signals.dtype != torch.float32:
        raise TypeError(f"signals must be float32, got {signals.dtype}")
    if signals.ndim < 1 or signals.shape[-1] < 1:
        raise ValueError(f"signals must be (..., T) with T >= 1, got shape "
                         f"{tuple(signals.shape)}")
    if not signals.is_contiguous():
        raise ValueError("signals must be contiguous")
    if merge_attempts < 0:
        raise ValueError(f"merge_attempts must be >= 0, got "
                         f"{merge_attempts}")
    batch_shape, T = signals.shape[:-1], signals.shape[-1]
    if moves is not None and (
            moves.dtype != torch.int32 or moves.shape != batch_shape
            or moves.device != signals.device or not moves.is_contiguous()):
        raise ValueError(f"moves must be contiguous int32 of shape "
                         f"{tuple(batch_shape)} on {signals.device}")
    y = signals.reshape(-1, T)
    B = y.shape[0]
    D = oasis_torch.stack_depth(T, depth)
    if B * max(T, D) >= 2 ** 31:
        raise ValueError(f"{B} traces x {max(T, D)} rows exceed the "
                         f"kernel's int32 indexing")
    dev = signals.device
    c = torch.empty((T, B), dtype=torch.float32, device=dev)
    s = torch.empty((T, B), dtype=torch.float32, device=dev)
    redo = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        yy = oasis_torch.shifted_input(y, g, lam).t().contiguous()
        plan = launch_plan(D, precise, B, sm_count(dev))
        stacks = ring_scratch(plan, D, B, dev)
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        args = [yy.data_ptr(), c.data_ptr(), s.data_ptr(), redo.data_ptr(),
                None if moves is None else moves.data_ptr(),
                stacks.data_ptr(), T, B, D, f32(g), f32(math.log(g)),
                f32(s_min), merge_attempts, f32(flag_tol)]
        lib = library().lib
        if precise:
            fn = lib.oasis_ar1_precise_launch
            args += oasis_torch.precise_constants(g)
        else:
            fn = lib.oasis_ar1_launch
        args += [plan.window, plan.lanes, plan.shared_bytes]
        with torch.cuda.device(dev):  # launches go to the current device
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        name = (("oasis_ar1_long" if T > PALLAS_MAX_T else "oasis_ar1")
                + ("_precise" if precise else "") + "/" + plan.storage)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed with CUDA "
                               f"error {err}")
        launches[name] += 1
    return (c.t().reshape(signals.shape), s.t().reshape(signals.shape),
            redo.reshape(batch_shape))


def pow_table(g: float, T: int, device) -> torch.Tensor:
    """``g^l`` for ``l = 0..T`` as float64 on ``device``, filled on the host
    by ``cg_pow_table`` (``csrc/oasis_host.cc``) with the very ``std::pow``
    call of the C++ redo, so the float64 redo on the card and its twin take
    the host's powers and no pow of their own; kept per ``(g, T,
    device)``."""
    key = (float(g), int(T), str(torch.device(device)))
    table = _pow_tables.get(key)
    if table is None:
        lib = build.load_host("oasis_host", build.CSRC / "oasis_host.cc").lib
        fn = lib.cg_pow_table
        fn.argtypes = [ctypes.c_double, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = None
        host = np.empty(T + 1, np.float64)
        fn(float(g), T, host.ctypes.data)
        table = _pow_tables[key] = torch.from_numpy(host).to(device)
    return table


def oasis_exact_f64(signals: torch.Tensor, rows: torch.Tensor,
                    spikes: torch.Tensor, g: float, s_min: float,
                    threshold: float) -> None:
    """Redo the traces ``signals[rows]`` of ``(N, T)`` float32 ``signals``
    exactly in float64 and write their int8 spikes into the same rows of
    ``spikes`` (``(N, T)`` int8, any strides), on ``signals``' device: the
    CUDA kernel for a CUDA tensor, :func:`oasis_exact_f64_torch` for a CPU
    one. The spikes are those of the C++ ``cg_deconvolve_batch``."""
    if signals.device.type == "cpu":
        s = oasis_exact_f64_torch(signals[rows], g, s_min)[1]
        spikes[rows] = (s > threshold).to(torch.int8)
        return
    if signals.device.type == "cuda":
        oasis_exact_f64_cuda(signals, rows, spikes, g, s_min, threshold)
        return
    raise ValueError(f"no OASIS kernel for device {signals.device}")


def oasis_exact_f64_cuda(signals: torch.Tensor, rows: torch.Tensor,
                         spikes: torch.Tensor, g: float, s_min: float,
                         threshold: float) -> None:
    """Launch the float64 redo on the rows ``rows`` (int64, each a row of
    ``signals``) of ``(N, T)`` contiguous float32 CUDA traces, writing
    int8 spikes into ``spikes`` on the same device; one launch a chunk of
    rows, each chunk gathered time-major with a scratch of
    ``_EXACT_SLOT_BYTES`` a frame and row."""
    if not signals.is_cuda:
        raise ValueError(f"signals must be a CUDA tensor, got "
                         f"{signals.device}")
    if signals.dtype != torch.float32 or spikes.dtype != torch.int8:
        raise TypeError(f"signals must be float32 and spikes int8, got "
                        f"{signals.dtype} and {spikes.dtype}")
    if signals.ndim != 2 or signals.shape[-1] < 1:
        raise ValueError(f"signals must be (N, T) with T >= 1, got shape "
                         f"{tuple(signals.shape)}")
    if not signals.is_contiguous():
        raise ValueError("signals must be contiguous")
    if spikes.shape != signals.shape or spikes.device != signals.device:
        raise ValueError(f"spikes must be {tuple(signals.shape)} on "
                         f"{signals.device}, got {tuple(spikes.shape)} on "
                         f"{spikes.device}")
    if (rows.dtype != torch.int64 or rows.ndim != 1
            or rows.device != signals.device):
        raise ValueError("rows must be a 1-D int64 tensor on signals' "
                         "device")
    rows = rows.contiguous()
    T = signals.shape[1]
    dev = signals.device
    chunk = max(1, _EXACT_SCRATCH_BYTES // (_EXACT_SLOT_BYTES * T))
    gpow = pow_table(g, T, dev)
    fn = library().lib.oasis_exact_f64_launch
    with torch.cuda.device(dev):  # launches go to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, rows.numel(), chunk):
            part = rows[lo:lo + chunk]
            y = signals.t().index_select(1, part).contiguous()  # (T, m)
            scratch = torch.empty(_EXACT_SLOT_BYTES * T * part.numel(),
                                  dtype=torch.uint8, device=dev)
            err = fn(y.data_ptr(), part.data_ptr(), gpow.data_ptr(),
                     scratch.data_ptr(), spikes.data_ptr(), T, part.numel(),
                     float(g), float(s_min), float(threshold),
                     spikes.stride(0), spikes.stride(1), WARP, stream)
            if err != 0:
                raise RuntimeError(f"oasis_exact_f64 kernel launch failed "
                                   f"with CUDA error {err}")
            launches["oasis_exact_f64/device"] += 1


def oasis_exact_f64_torch(traces: torch.Tensor, g: float, s_min: float):
    """The float64 redo in plain PyTorch, where the traces lie: the kernel's
    twin. ``(c, s)`` float64 of ``(n, T)`` float32 traces, ``cg_oasis_ar1``'s
    with ``lam`` 0 bit for bit; the spikes are ``s > threshold``.

    The pool machine of ``cg_oasis_ar1`` with no depth limit, batched over
    lanes as :func:`~calciumgan_tpu_torch.ops.oasis.oasis_ar1_while` is: an
    iteration merges a lane's top pool into the one below where
    ``v0/w0 >= g^l1 * (v1/w1) + s_min`` fails, and pushes the lane's next
    frame otherwise, each operation a float64 one in the host's order and
    ``g^l`` from :func:`pow_table`. The reconstruction runs frame by frame:
    ``h = max(v/w, 0)`` opens a pool (``-0.0`` stays, as ``std::max``
    keeps it), then ``c[t] = c[t-1] * g``; ``s[t] = c[t] - g*c[t-1]``,
    ``s[0] = 0``."""
    y = torch.as_tensor(traces, dtype=torch.float32).to(torch.float64)
    if y.ndim != 2 or y.shape[1] < 1:
        raise ValueError(f"traces must be (n, T) with T >= 1, got shape "
                         f"{tuple(y.shape)}")
    B, T = y.shape
    dev = y.device
    gpow = pow_table(g, T, dev)
    v = torch.zeros((B, T), dtype=torch.float64, device=dev)
    w = torch.ones_like(v)
    ln = torch.zeros((B, T), dtype=torch.long, device=dev)
    v[:, 0], ln[:, 0] = y[:, 0], 1
    lanes = torch.arange(B, device=dev)
    t = torch.ones(B, dtype=torch.long, device=dev)  # next frame to push
    p = torch.zeros(B, dtype=torch.long, device=dev)  # top pool
    while True:
        q = (p - 1).clamp_min(0)
        vp, wp, lp = v[lanes, p], w[lanes, p], ln[lanes, p]
        vq, wq, lq = v[lanes, q], w[lanes, q], ln[lanes, q]
        gl = gpow[lq]
        viol = (p > 0) & ~(vp / wp >= gl * (vq / wq) + s_min)
        push = ~viol & (t < T)
        if not bool((viol | push).any()):
            break
        m = torch.nonzero(viol).squeeze(1)
        v[m, q[m]] = (vq + gl * vp)[m]
        w[m, q[m]] = (wq + gl * gl * wp)[m]
        ln[m, q[m]] = (lq + lp)[m]
        u = torch.nonzero(push).squeeze(1)
        v[u, p[u] + 1] = y[u, t[u]]
        w[u, p[u] + 1] = 1.0
        ln[u, p[u] + 1] = 1
        p = p - viol.long() + push.long()
        t = t + push.long()

    idx = torch.arange(T, device=dev)
    valid = idx < (p + 1)[:, None]
    l_masked = torch.where(valid, ln, 0)
    starts = torch.cumsum(l_masked, 1) - l_masked
    starts = torch.where(valid, starts, T)  # empty pools start after T
    pool_id = torch.searchsorted(starts, idx.expand(B, T).contiguous(),
                                 right=True) - 1
    q = v / w
    h = torch.where(q < 0.0, torch.zeros_like(q), q).gather(1, pool_id)
    opens = starts.gather(1, pool_id) == idx
    c = torch.empty_like(v)
    c[:, 0] = h[:, 0]
    for k in range(1, T):
        c[:, k] = torch.where(opens[:, k], h[:, k], c[:, k - 1] * g)
    s = torch.zeros_like(c)
    s[:, 1:] = c[:, 1:] - g * c[:, :-1]
    return c, s
