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
allocates the outputs and, for the device-memory ring, the ``(3, D, B)``
stack scratch; the kernel allocates nothing and does not synchronise.

Where each trace's ring of ``D`` pool slots lives is a pure function of
``(D, precise)``, :func:`launch_plan`: in shared memory, one warp of traces
per block, wherever that fits (``D <= 605``: every rung of the short ladder
and the long ladder's first rung at 20,000 frames), else in device memory.
There is no switch; a refused launch raises.

Each entry takes the plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches
by machine, trace length and ring storage, whichever entry made them:
``oasis_ar1`` and ``oasis_ar1_precise`` for traces of up to
``PALLAS_MAX_T`` frames, ``oasis_ar1_long`` and ``oasis_ar1_long_precise``
for longer ones, each with ``/shared`` or ``/device`` (e.g.
``oasis_ar1_long_precise/shared``).
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

# dynamic shared memory one block may opt into on Hopper (sm_90)
SHARED_BYTES_MAX = 232_448
WARP = 32
# traces per block of the device-memory ring
_DEVICE_LANES = 128
# the float32 fields of a ring slot, by machine (precise: the bfloat16-
# rounded compensation of v is kept widened to float32)
_RING_FIELDS = {False: ("v", "w", "l"), True: ("v", "ve", "l")}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    storage: str       # "shared" or "device": where the rings live
    lanes: int         # traces (threads) per block, a multiple of 32
    shared_bytes: int  # dynamic shared memory per block


def launch_plan(D: int, precise: bool) -> LaunchPlan:
    """Where a launch with ``D``-slot rings keeps them: in shared memory,
    laid out ``[field][slot][lane]`` for one warp of traces per block,
    wherever that fits in ``SHARED_BYTES_MAX``; else in a ``(3, D, B)``
    device-memory scratch, ``_DEVICE_LANES`` traces per block."""
    ring_bytes = 4 * len(_RING_FIELDS[precise]) * D * WARP
    if ring_bytes <= SHARED_BYTES_MAX:
        return LaunchPlan("shared", WARP, ring_bytes)
    return LaunchPlan("device", _DEVICE_LANES, 0)


def ring_scratch(plan: LaunchPlan, D: int, B: int, device) -> torch.Tensor:
    """The device-memory rings of ``plan``: ``(3, D, B)`` float32 for the
    device storage, an empty tensor for the shared one (the kernel keeps
    its rings in shared memory and takes no scratch)."""
    if plan.storage == "shared":
        return torch.empty((0,), dtype=torch.float32, device=device)
    return torch.empty((3, D, B), dtype=torch.float32, device=device)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_float])
_PLAN_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
_CLASSIC_ARGTYPES = _ARGTYPES + _PLAN_ARGTYPES
_PRECISE_ARGTYPES = _ARGTYPES + [ctypes.c_float] * 3 + _PLAN_ARGTYPES


def library() -> build.Built:
    """The built kernel library (compiled by ``nvcc`` at first use)."""
    built = build.load("oasis_ar1")
    for name, argtypes in (("oasis_ar1_launch", _CLASSIC_ARGTYPES),
                           ("oasis_ar1_precise_launch", _PRECISE_ARGTYPES)):
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return built


def oasis_ar1(signals: torch.Tensor, g: float = 0.95, lam: float = 0.0,
              s_min: float = 0.0, depth: int | None = None,
              merge_attempts: int = 4, flag_tol: float = 0.0,
              precise: bool = False):
    """OASIS AR(1) with the redo bitmask, on ``signals``' device: the CUDA
    kernel for a CUDA tensor, the plain PyTorch version for a CPU one.
    ``depth=None`` is ``min(T, 128)`` rows, as ``oasis_ar1_pallas``'s."""
    args = (g, lam, s_min, depth, merge_attempts, flag_tol, precise)
    if signals.device.type == "cpu":
        return oasis_torch.oasis_ar1_torch(signals, *args)
    if signals.device.type == "cuda":
        return oasis_ar1_cuda(signals, *args)
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
                   precise: bool = False):
    """Launch the kernel on ``(..., T)`` contiguous float32 CUDA traces,
    with the classic or the ``precise`` machine."""
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
        plan = launch_plan(D, precise)
        stacks = ring_scratch(plan, D, B, dev)
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        args = [yy.data_ptr(), c.data_ptr(), s.data_ptr(), redo.data_ptr(),
                stacks.data_ptr(), T, B, D, f32(g), f32(math.log(g)),
                f32(s_min), merge_attempts, f32(flag_tol)]
        lib = library().lib
        if precise:
            fn = lib.oasis_ar1_precise_launch
            args += oasis_torch.precise_constants(g)
        else:
            fn = lib.oasis_ar1_launch
        args += [int(plan.storage == "shared"), plan.lanes, plan.shared_bytes]
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
