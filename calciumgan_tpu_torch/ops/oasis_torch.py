"""OASIS AR(1) stack machines in plain PyTorch: the CUDA kernel's twin.

The same function as ``csrc/oasis_ar1.cu`` and as the Pallas kernels it
ports (``calciumgan_tpu/ops/oasis_pallas.py``: ``oasis_ar1_pallas``
``:599-672`` and the time-chunked ``oasis_ar1_pallas_long`` ``:509-596``):
a Python loop over time, vectorised over traces, with the same fixed merge
budget, the same float32 decisions, the same redo bitmask and the same
reconstruction. It is what :mod:`calciumgan_tpu_torch.ops.oasis_cuda` runs
for a tensor on the CPU, and what the kernel is held against on the card.

Two machines, as in the JAX package:

- classic (``_stack_machine``, ``:150-274``): pool values ``v`` and weights
  ``w`` accumulated in float32, decision ``v0/w0 < g^l1 * v1/w1 + s_min``;
- precise (``_stack_machine_precise``, ``:277-392``): ``v`` carried as a
  double-single pair whose compensation term is stored in bfloat16 (rounded
  to nearest even, widened on every read), ``w`` never stored but taken
  from the closed form ``w(l) = -expm1(2 l ln g) / (1 - g^2)``, ``g^l``
  from a 12-bit split of ``ln g``, and a division-free decision.

The pool stack of each trace is a ring of ``D`` slots with a per-trace top
index. Pallas keeps its stack with the top at row 0 and rolls it by one row
per push or merge; row ``i`` there is ring slot ``(top - i) mod D`` here,
slot for slot, so even a trace whose stack overflowed (redo bit 0) sees the
same pools and sets the same bits.

The time-chunked long kernel runs the same machines in the same order; its
chunks exist only to fit the TPU's VMEM, so :func:`oasis_ar1_long_torch` is
the whole-trace loop with the long kernel's default depth.

``calls`` counts the calls of :func:`oasis_ar1_torch` (and so of
:func:`oasis_ar1_long_torch`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

calls = 0


def stack_depth(T: int, depth: int | None = None) -> int:
    """Pool-stack rows ``D`` as the Pallas kernels size them
    (``oasis_pallas.py:539,633-634``): ``min(T, depth or 128)``, rounded up
    to a multiple of 8, at least 8."""
    d = min(T, 128) if depth is None else min(T, depth)
    return max(8, -(-d // 8) * 8)


def shifted_input(y: torch.Tensor, g: float, lam: float) -> torch.Tensor:
    """The sparsity penalty's shift of ``(B, T)`` traces: ``y - lam*(1-g)``,
    and ``y - lam`` at the last frame (``oasis_pallas.py:543-544,638-639``)."""
    yy = y - lam * (1.0 - g)
    yy[:, -1] = y[:, -1] - lam
    return yy


def _f32(x: float) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Precise-mode helpers: double-single float32 arithmetic, as
# oasis_pallas.py:83-141. Every constant is rounded to float32 once, as JAX's
# weak typing rounds a Python float, and every sum and product rounds on its
# own: TwoSum and the Veltkamp split are exact only without contraction.
# ---------------------------------------------------------------------------

def split12(x: float) -> tuple:
    """``(hi, lo)``: ``hi`` keeps the top 12 significand bits of ``f32(x)``,
    so an integer up to 2^12 times ``hi`` is exact in float32, and ``lo``
    is the float32 residual of the float64 ``x``
    (``oasis_pallas.py:83-91``)."""
    x32 = np.float32(x)
    c = np.float32(x32 * np.float32(2 ** 12 + 1))
    hi = np.float32(c - np.float32(c - x32))
    return float(hi), float(np.float32(float(x) - float(hi)))


def precise_constants(g: float) -> tuple:
    """``(lng_hi, lng_lo, inv_1mg2)`` of the precise machine, as
    ``oasis_pallas.py:288-290`` computes them on the host."""
    lng_hi, lng_lo = split12(math.log(g))
    return lng_hi, lng_lo, _f32(1.0 / (1.0 - float(g) * float(g)))


def _two_sum(a, b):
    """Knuth TwoSum: ``s + e == a + b`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    """Dekker, for ``|a| >= |b|``."""
    s = a + b
    return s, b - (s - a)


def _veltkamp_split(a):
    c = a * _f32(2 ** 12 + 1)
    hi = c - (c - a)
    return hi, a - hi


def _two_product(a, b):
    """``p + e == a * b`` exactly, by Veltkamp splits."""
    p = a * b
    ah, al = _veltkamp_split(a)
    bh, bl = _veltkamp_split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


_C6 = _f32(1 / 6)
# Taylor coefficients 1/2 ... 1/362880 of _expm1_neg, innermost last
_EXPM1_TAYLOR = tuple(_f32(1 / math.factorial(k)) for k in range(2, 10))


def _poly_expm1_small(u):
    """expm1(u) for ``|u| <= ~0.06``: cubic Horner."""
    return u * (1.0 + u * (0.5 + u * _C6))


def _expm1_neg(x_hi, x_lo):
    """expm1(x_hi + x_lo) for x <= 0: degree-10 Taylor for ``x > -0.5``,
    ``exp(x) - 1`` below (``oasis_pallas.py:129-141``)."""
    x = x_hi + x_lo
    acc = x * _EXPM1_TAYLOR[-1]
    for coef in _EXPM1_TAYLOR[-2::-1]:
        acc = x * (coef + acc)
    t = x * (1.0 + acc)
    e = torch.exp(x_hi) * (1.0 + _poly_expm1_small(x_lo))
    return torch.where(x > -0.5, t, e - 1.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and widen back, as the Pallas
    kernel stores and reads its compensation stack."""
    return x.to(torch.bfloat16).float()


class _Ring:
    """Per-trace rings of ``D`` slots, one ``(B*D,)`` float32 plane per
    stack field, read and written at flat slot indices."""

    def __init__(self, B: int, D: int, dev, fields: dict):
        self.D = D
        self.base = torch.arange(B, device=dev) * D
        self.planes = {k: torch.full((B * D,), v, dtype=torch.float32,
                                     device=dev) for k, v in fields.items()}

    def at(self, slot):
        return self.base + slot

    def get(self, name, idx):
        return self.planes[name][idx]

    def put(self, name, idx, value):
        self.planes[name][idx] = value

    def table(self, name):
        return self.planes[name].view(-1, self.D)


def _forward_classic(yy, D, g, s_min, K, tol):
    """The classic machine's forward sweep (``oasis_pallas.py:184-271``);
    returns ``(heights, lengths, top, n, redo)``."""
    B, T = yy.shape
    dev = yy.device
    log_g = _f32(math.log(g))
    st = _Ring(B, D, dev, {"v": 0.0, "w": 1.0, "l": 1.0})
    top = torch.full((B,), D - 1, dtype=torch.long, device=dev)
    n = torch.zeros((B,), dtype=torch.int32, device=dev)
    redo = torch.zeros((B,), dtype=torch.int32, device=dev)

    def violation(top, n):
        below = (top - 1) % D
        i0, i1 = st.at(top), st.at(below)
        v0, w0 = st.get("v", i0), st.get("w", i0)
        v1, w1, l1 = st.get("v", i1), st.get("w", i1), st.get("l", i1)
        gl = torch.exp(l1 * log_g)
        lhs = v0 / w0
        rhs = gl * (v1 / w1) + s_min
        active = n >= 2
        viol = active & (lhs < rhs)
        bord = active & ((lhs - rhs).abs() < tol * (1.0 + rhs.abs()))
        return viol, bord, below, i0, i1, gl, v0, w0, v1, w1, l1

    for t in range(T):
        top = (top + 1) % D
        i0 = st.at(top)
        st.put("v", i0, yy[:, t])
        st.put("w", i0, 1.0)
        st.put("l", i0, 1.0)
        n = n + 1
        redo |= (n > D).int()
        for _ in range(K):
            viol, bord, below, i0, i1, gl, v0, w0, v1, w1, l1 = violation(
                top, n)
            l0 = st.get("l", i0)
            st.put("v", i1, torch.where(viol, v1 + gl * v0, v1))
            st.put("w", i1, torch.where(viol, w1 + gl * gl * w0, w1))
            st.put("l", i1, torch.where(viol, l1 + l0, l1))
            top = torch.where(viol, below, top)
            n = n - viol.int()
            if tol > 0.0:
                redo |= bord.int() * 4
        viol, bord = violation(top, n)[:2]
        redo |= viol.int() * 2
        if tol > 0.0:
            redo |= bord.int() * 4
    heights = torch.clamp_min(st.table("v") / st.table("w"), 0.0)
    return heights, st.table("l"), top, n, redo


def _forward_precise(yy, D, g, s_min, K, tol):
    """The precise machine's forward sweep (``oasis_pallas.py:288-389``);
    returns ``(heights, lengths, top, n, redo)``."""
    B, T = yy.shape
    dev = yy.device
    lng_hi, lng_lo, inv_1mg2 = precise_constants(g)
    # v_hi, the bfloat16-valued compensation v_lo, and the exact lengths;
    # Pallas starts every row at v=0, v_lo=0, l=1
    st = _Ring(B, D, dev, {"vh": 0.0, "ve": 0.0, "l": 1.0})
    top = torch.full((B,), D - 1, dtype=torch.long, device=dev)
    n = torch.zeros((B,), dtype=torch.int32, device=dev)
    redo = torch.zeros((B,), dtype=torch.int32, device=dev)

    def gl_of(l):
        # g^l with an exact exp argument for integer l <= 4096
        return torch.exp(l * lng_hi) * (1.0 + _poly_expm1_small(l * lng_lo))

    def w_of(l):
        # w(1) == 1 exactly
        m = _expm1_neg((2.0 * l) * lng_hi, (2.0 * l) * lng_lo)
        return torch.where(l == 1.0, 1.0, -m * inv_1mg2)

    def violation(top, n):
        # F = v0*w1 - w0*R, R = gl*v1 + s_min*w1: viol <=> F < 0, band
        # |F| < tol * w0*(w1 + |R|). Pallas drops w0 on the first attempt,
        # where the pool just pushed has l0 = 1; w_of(1) == 1 exactly and a
        # product by 1 is exact, so the general form makes the same decision
        below = (top - 1) % D
        i0, i1 = st.at(top), st.at(below)
        v0h, v0e = st.get("vh", i0), st.get("ve", i0)
        v1h, v1e, l1 = st.get("vh", i1), st.get("ve", i1), st.get("l", i1)
        gl = gl_of(l1)
        w1 = w_of(l1)
        R = gl * v1h + gl * v1e + s_min * w1
        v0w1 = v0h * w1 + v0e * w1
        w0 = w_of(st.get("l", i0))
        F = v0w1 - w0 * R
        scale = w0 * (w1 + R.abs())
        active = n >= 2
        viol = active & (F < 0.0)
        bord = active & (F.abs() < tol * scale)
        return viol, bord, below, i0, i1, gl, v0h, v0e, v1h, v1e, l1

    for t in range(T):
        top = (top + 1) % D
        i0 = st.at(top)
        st.put("vh", i0, yy[:, t])
        st.put("ve", i0, 0.0)
        st.put("l", i0, 1.0)
        n = n + 1
        redo |= (n > D).int()
        for _ in range(K):
            viol, bord, below, i0, i1, gl, v0h, v0e, v1h, v1e, l1 = (
                violation(top, n))
            # compensated mv = v1 + gl*v0
            p, pe = _two_product(gl, v0h)
            s, se = _two_sum(v1h, p)
            mve = ((se + pe) + gl * v0e) + v1e
            mvh, mve = _fast_two_sum(s, mve)
            l0 = st.get("l", i0)
            st.put("vh", i1, torch.where(viol, mvh, v1h))
            st.put("ve", i1, torch.where(viol, _bf16(mve), v1e))
            st.put("l", i1, torch.where(viol, l1 + l0, l1))
            top = torch.where(viol, below, top)
            n = n - viol.int()
            if tol > 0.0:
                redo |= bord.int() * 4
        viol, bord = violation(top, n)[:2]
        redo |= viol.int() * 2
        if tol > 0.0:
            redo |= bord.int() * 4
    ls = st.table("l")
    heights = torch.clamp_min((st.table("vh") + st.table("ve")) / w_of(ls),
                              0.0)
    return heights, ls, top, n, redo


def _reconstruct(heights, ls, top, n, T, g):
    """``c``, ``s`` from the final pools: walk them from the bottom of the
    stack forward, ``c[t] = h * g^k`` at offset ``k`` into a pool of height
    ``h`` (the Pallas backward replay, ``:395-411``, visits the same pools
    with the same exponents); ``s[t] = c[t] - g*c[t-1]``, ``s[0] = 0``."""
    B, D = heights.shape
    dev = heights.device
    log_g = _f32(math.log(g))
    rows = torch.arange(B, device=dev)
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
    s[:, 1:] = c[:, 1:] - _f32(g) * c[:, :-1]
    return c, s


def oasis_ar1_torch(signals: torch.Tensor, g: float = 0.95,
                    lam: float = 0.0, s_min: float = 0.0,
                    depth: int | None = None, merge_attempts: int = 4,
                    flag_tol: float = 0.0, precise: bool = False):
    """Batched OASIS AR(1) on ``(..., T)`` float32 traces.

    Returns ``(c, s, redo)``: the denoised trace and spikes shaped like
    ``signals`` and an int32 bitmask per trace (batch shape). Bit 0: the
    pool stack outgrew ``depth``; bit 1: a violation survived
    ``merge_attempts`` merges in one timestep; bit 2: a merge decision fell
    inside the relative band ``flag_tol`` (off at 0) around its boundary.
    ``precise`` selects the compensated machine. The output of a flagged
    trace is unspecified."""
    global calls
    calls += 1
    signals = signals.float()
    batch_shape, T = signals.shape[:-1], signals.shape[-1]
    y = signals.reshape(-1, T)
    D = stack_depth(T, depth)
    forward = _forward_precise if precise else _forward_classic
    heights, ls, top, n, redo = forward(
        shifted_input(y, g, lam), D, g, _f32(s_min), merge_attempts,
        _f32(flag_tol))
    c, s = _reconstruct(heights, ls, top, n, T, g)
    return (c.reshape(signals.shape), s.reshape(signals.shape),
            redo.reshape(batch_shape))


def oasis_ar1_long_torch(signals: torch.Tensor, g: float = 0.95,
                         lam: float = 0.0, s_min: float = 0.0,
                         depth: int = 512, merge_attempts: int = 4,
                         flag_tol: float = 0.0, precise: bool = False):
    """:func:`oasis_ar1_torch` with the defaults of the time-chunked
    ``oasis_ar1_pallas_long``: a 512-row stack (any T)."""
    return oasis_ar1_torch(signals, g, lam, s_min, depth, merge_attempts,
                           flag_tol, precise)
