"""OASIS AR(1) on the GPU: the wrapper of the hand-written Hopper kernel
``csrc/oasis_ar1.cu`` and the device dispatch.

The kernel replaces the Pallas TPU kernel ``oasis_ar1_pallas``
(``calciumgan_tpu/ops/oasis_pallas.py:599-672``) with the same signature
``(signals, g, lam, s_min, depth, merge_attempts, flag_tol) -> (c, s,
redo)`` and the same redo bitmask (see :mod:`.oasis_torch`, its plain
PyTorch twin, for the contract). The wrapper keeps the TPU kernel's
time-major ``(T, B)`` layout so that each timestep's load across a warp is
coalesced, applies the ``lam`` shift, and allocates the outputs and the
``(3, D, B)`` stack scratch; the kernel allocates nothing and does not
synchronise.

:func:`oasis_ar1` takes the plain version only for a tensor on the CPU. A
CUDA tensor launches the kernel or raises. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from calciumgan_tpu_torch.kernels import build
from calciumgan_tpu_torch.ops import oasis_torch

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p])


def library() -> build.Built:
    """The built kernel library (compiled by ``nvcc`` at first use)."""
    built = build.load("oasis_ar1")
    fn = built.lib.oasis_ar1_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return built


def oasis_ar1(signals: torch.Tensor, g: float = 0.95, lam: float = 0.0,
              s_min: float = 0.0, depth: int | None = None,
              merge_attempts: int = 4, flag_tol: float = 0.0,
              precise: bool = False):
    """OASIS AR(1) with the redo bitmask, on ``signals``' device: the CUDA
    kernel for a CUDA tensor, the plain PyTorch version for a CPU one."""
    if precise:
        raise NotImplementedError(
            "precise=True (the compensated stack machine of "
            "oasis_pallas._stack_machine_precise) is not ported yet: "
            "ROADMAP, still to port: the short kernel's precise mode")
    args = (g, lam, s_min, depth, merge_attempts, flag_tol)
    if signals.device.type == "cpu":
        return oasis_torch.oasis_ar1_torch(signals, *args)
    if signals.device.type == "cuda":
        return oasis_ar1_cuda(signals, *args)
    raise ValueError(f"no OASIS kernel for device {signals.device}")


def oasis_ar1_cuda(signals: torch.Tensor, g: float = 0.95, lam: float = 0.0,
                   s_min: float = 0.0, depth: int | None = None,
                   merge_attempts: int = 4, flag_tol: float = 0.0):
    """Launch the kernel on ``(..., T)`` contiguous float32 CUDA traces."""
    global launches
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
        fn = library().lib.oasis_ar1_launch
        with torch.cuda.device(dev):  # launches go to the current device
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(yy.data_ptr(), c.data_ptr(), s.data_ptr(),
                     redo.data_ptr(), stacks.data_ptr(), T, B, D, f32(g),
                     f32(math.log(g)), f32(s_min), merge_attempts,
                     f32(flag_tol), stream)
        if err != 0:
            raise RuntimeError(f"oasis_ar1 kernel launch failed with CUDA "
                               f"error {err}")
        launches += 1
    return (c.t().reshape(signals.shape), s.t().reshape(signals.shape),
            redo.reshape(batch_shape))
