"""OASIS AR(1) on the GPU: the wrappers of the hand-written Hopper kernel
``csrc/oasis_ar1.cu`` and the device dispatch.

The kernel replaces both Pallas TPU kernels of
``calciumgan_tpu/ops/oasis_pallas.py``, each with the classic or the precise
stack machine:

- :func:`oasis_ar1` replaces ``oasis_ar1_pallas`` (``:599-672``);
- :func:`oasis_ar1_long` replaces the time-chunked ``oasis_ar1_pallas_long``
  (``:509-596``), for recordings of any length.

Both keep the TPU kernels' signatures ``(signals, g, lam, s_min, depth,
merge_attempts, flag_tol, precise) -> (c, s, redo)`` and redo bitmask (see
:mod:`.oasis_torch`, their plain PyTorch twin, for the contract). The
wrapper keeps the TPU kernel's time-major ``(T, B)`` layout so that each
timestep's load across a warp is coalesced, applies the ``lam`` shift, and
allocates the outputs and the ``(3, D, B)`` stack scratch; the kernel
allocates nothing and does not synchronise.

Each entry takes the plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches
by machine and trace length, whichever entry made them: ``oasis_ar1`` and
``oasis_ar1_precise`` for traces of up to ``PALLAS_MAX_T`` frames,
``oasis_ar1_long`` and ``oasis_ar1_long_precise`` for longer ones.
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from calciumgan_tpu_torch.kernels import build
from calciumgan_tpu_torch.ops import oasis_torch

launches: collections.Counter = collections.Counter()

# longest trace oasis_ar1_pallas holds in VMEM (JAX ops/oasis.py:250-260);
# beyond it the JAX package runs the long kernel
PALLAS_MAX_T = 4096

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_float])
_CLASSIC_ARGTYPES = _ARGTYPES + [ctypes.c_void_p]
_PRECISE_ARGTYPES = _ARGTYPES + [ctypes.c_float] * 3 + [ctypes.c_void_p]


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
    On the GPU one thread walks a whole trace and its stacks live in device
    memory, so nothing has to be carried between grid steps and the
    whole-trace kernel serves any ``T``."""
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
        stacks = torch.empty((3, D, B), dtype=torch.float32, device=dev)
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
        with torch.cuda.device(dev):  # launches go to the current device
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        name = (("oasis_ar1_long" if T > PALLAS_MAX_T else "oasis_ar1")
                + ("_precise" if precise else ""))
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed with CUDA "
                               f"error {err}")
        launches[name] += 1
    return (c.t().reshape(signals.shape), s.t().reshape(signals.shape),
            redo.reshape(batch_shape))
