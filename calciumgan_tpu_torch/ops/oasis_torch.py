"""OASIS AR(1) stack machine in plain PyTorch: the CUDA kernel's twin.

The same function as ``csrc/oasis_ar1.cu`` and as the Pallas kernel it
ports (``calciumgan_tpu/ops/oasis_pallas.py:599-672``): a Python loop over
time, vectorised over traces, with the same fixed merge budget, the same
float32 decisions, the same redo bitmask and the same reconstruction. It is
what :func:`calciumgan_tpu_torch.ops.oasis_cuda.oasis_ar1` runs for a tensor
on the CPU, and what the kernel is held against on the card.

The pool stack of each trace is a ring of ``D`` slots with a per-trace top
index. Pallas keeps its stack with the top at row 0 and rolls it by one row
per push or merge (``_stack_machine``, ``:150-274``); row ``i`` there is
ring slot ``(top - i) mod D`` here, slot for slot, so even a trace whose
stack overflowed (redo bit 0) sees the same pools and sets the same bits.

``calls`` counts the calls of :func:`oasis_ar1_torch`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

calls = 0


def stack_depth(T: int, depth: int | None = None) -> int:
    """Pool-stack rows ``D`` as the Pallas kernel sizes them
    (``oasis_pallas.py:633-634``): ``min(T, depth or 128)``, rounded up to
    a multiple of 8, at least 8."""
    d = min(T, 128) if depth is None else min(T, depth)
    return max(8, -(-d // 8) * 8)


def shifted_input(y: torch.Tensor, g: float, lam: float) -> torch.Tensor:
    """The sparsity penalty's shift of ``(B, T)`` traces: ``y - lam*(1-g)``,
    and ``y - lam`` at the last frame (``oasis_pallas.py:638-639``)."""
    yy = y - lam * (1.0 - g)
    yy[:, -1] = y[:, -1] - lam
    return yy


def _f32(x: float) -> float:
    return float(np.float32(x))


def oasis_ar1_torch(signals: torch.Tensor, g: float = 0.95,
                    lam: float = 0.0, s_min: float = 0.0,
                    depth: int | None = None, merge_attempts: int = 4,
                    flag_tol: float = 0.0):
    """Batched OASIS AR(1) on ``(..., T)`` float32 traces.

    Returns ``(c, s, redo)``: the denoised trace and spikes shaped like
    ``signals`` and an int32 bitmask per trace (batch shape). Bit 0: the
    pool stack outgrew ``depth``; bit 1: a violation survived
    ``merge_attempts`` merges in one timestep; bit 2: a merge decision fell
    inside the relative band ``flag_tol*(1+|rhs|)`` (off at 0). The output
    of a flagged trace is unspecified."""
    global calls
    calls += 1
    signals = signals.float()
    batch_shape, T = signals.shape[:-1], signals.shape[-1]
    y = signals.reshape(-1, T)
    B, dev = y.shape[0], y.device
    D = stack_depth(T, depth)
    yy = shifted_input(y, g, lam)
    g32, log_g = _f32(g), _f32(math.log(g))
    s_min32, tol = _f32(s_min), _f32(flag_tol)

    vs = torch.zeros((B, D), dtype=torch.float32, device=dev)
    ws = torch.ones((B, D), dtype=torch.float32, device=dev)
    ls = torch.ones((B, D), dtype=torch.float32, device=dev)
    rows = torch.arange(B, device=dev)
    top = torch.full((B,), D - 1, dtype=torch.long, device=dev)
    n = torch.zeros((B,), dtype=torch.int32, device=dev)
    redo = torch.zeros((B,), dtype=torch.int32, device=dev)

    def violation(top, n):
        below = (top - 1) % D
        v0, w0 = vs[rows, top], ws[rows, top]
        v1, w1, l1 = vs[rows, below], ws[rows, below], ls[rows, below]
        gl = torch.exp(l1 * log_g)
        lhs = v0 / w0
        rhs = gl * (v1 / w1) + s_min32
        active = n >= 2
        viol = active & (lhs < rhs)
        bord = active & ((lhs - rhs).abs() < tol * (1.0 + rhs.abs()))
        return viol, bord, below, gl, v0, w0, v1, w1, l1

    for t in range(T):
        top = (top + 1) % D
        vs[rows, top] = yy[:, t]
        ws[rows, top] = 1.0
        ls[rows, top] = 1.0
        n = n + 1
        redo |= (n > D).int()
        for _ in range(merge_attempts):
            viol, bord, below, gl, v0, w0, v1, w1, l1 = violation(top, n)
            l0 = ls[rows, top]
            vs[rows, below] = torch.where(viol, v1 + gl * v0, v1)
            ws[rows, below] = torch.where(viol, w1 + gl * gl * w0, w1)
            ls[rows, below] = torch.where(viol, l1 + l0, l1)
            top = torch.where(viol, below, top)
            n = n - viol.int()
            if tol > 0.0:
                redo |= bord.int() * 4
        viol, bord = violation(top, n)[:2]
        redo |= viol.int() * 2
        if tol > 0.0:
            redo |= bord.int() * 4

    # reconstruction: walk the pools from the bottom of the stack forward,
    # c[t] = h * g^k at offset k into a pool of height h = max(v/w, 0)
    heights = torch.clamp_min(vs / ws, 0.0)
    pos = (top - (n.clamp(1, D).long() - 1)) % D
    h, length = heights[rows, pos], ls[rows, pos]
    k = torch.zeros((B,), dtype=torch.float32, device=dev)
    c = torch.empty((B, T), dtype=torch.float32, device=dev)
    for t in range(T):
        if t:
            adv = k >= length
            pos = torch.where(adv, (pos + 1) % D, pos)
            h = torch.where(adv, heights[rows, pos], h)
            length = torch.where(adv, ls[rows, pos], length)
            k = torch.where(adv, torch.zeros_like(k), k)
        c[:, t] = h * torch.exp(k * log_g)
        k = k + 1.0
    s = torch.zeros_like(c)
    s[:, 1:] = c[:, 1:] - g32 * c[:, :-1]
    return (c.reshape(signals.shape), s.reshape(signals.shape),
            redo.reshape(batch_shape))
