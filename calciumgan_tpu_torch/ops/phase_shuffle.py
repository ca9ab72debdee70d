"""WaveGAN phase shuffle (copy of ``phase_shuffle``, ``phase_shuffle_2d`` and
``_shift_axis`` in ``calciumgan_tpu/ops/phase_shuffle.py:24-63``).

One shift per call, shared by the whole batch: the feature map is
reflect-padded by ``m`` (edge excluded, as ``jnp.pad(mode="reflect")`` and
``F.pad(mode="reflect")`` both pad) and cropped back at offset ``m +
shift``. Pad and shift are clamped to ``width - 1`` so tiny feature maps
saturate instead of failing.

The shift is a slice offset, so it is a host integer: :func:`draw_shifts`
draws it from a CPU ``torch.Generator`` (a draw on the card would cost a
synchronisation per layer), and callers may pass shifts in explicitly, which
is how the tests replay the JAX package's draws. The 2-D variant takes a
(time, neuron) pair of them.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F


def draw_shifts(gen: torch.Generator, m: int, count: int) -> List[int]:
    """``count`` shifts uniform on ``-m..m`` from the CPU generator
    ``gen``."""
    if m <= 0 or count == 0:
        return []
    return torch.randint(-m, m + 1, (count,), generator=gen).tolist()


def phase_shuffle(x: torch.Tensor, shift: int, m: int,
                  axis: int = -1) -> torch.Tensor:
    """``x`` shifted along ``axis`` by ``shift`` (drawn from ``-m..m``),
    reflect-padding the edges; identity for ``m == 0``."""
    if m == 0:
        return x
    return _shift_axis(x, shift, m, axis)


def phase_shuffle_2d(x: torch.Tensor, shifts: Sequence[int], m: int,
                     n: int, time_axis: int = -2,
                     neuron_axis: int = -1) -> torch.Tensor:
    """``x`` shifted along ``time_axis`` by ``shifts[0]`` (drawn from
    ``-m..m``) if ``m > 0``, then along ``neuron_axis`` by ``shifts[1]``
    (from ``-n..n``) if ``n > 0``; the default axes are NCHW's."""
    if m > 0:
        x = _shift_axis(x, shifts[0], m, time_axis)
    if n > 0:
        x = _shift_axis(x, shifts[1], n, neuron_axis)
    return x


def folded_shape(shape: Sequence[int], axis: int) -> tuple:
    """The 3-D ``(N, C, W)`` view that :func:`_shift_axis` reflect-pads for
    a map of ``shape`` shifted along ``axis``. ``F.pad``'s reflect kernel
    on the card puts N and C on grid axes of at most 65,535 blocks, so the
    leading axes are not folded into one: N is the first of them and C the
    product of the rest (the 1-D critic's ``(B, C, W)`` as is)."""
    axis = axis % len(shape)
    lead = [w for i, w in enumerate(shape) if i != axis]
    rows = lead[0] if len(lead) > 1 else 1
    return rows, math.prod(lead) // rows, shape[axis]


def _shift_axis(x: torch.Tensor, shift: int, m: int,
                axis: int) -> torch.Tensor:
    axis = axis % x.ndim
    width = x.shape[axis]
    if width <= 1:
        return x
    m = min(m, width - 1)
    shift = max(-m, min(m, int(shift)))
    if shift == 0:
        return x
    moved = x.movedim(axis, -1)
    padded = F.pad(moved.reshape(folded_shape(x.shape, axis)), (m, m),
                   mode="reflect")
    out = padded[..., m + shift:m + shift + width]
    return out.reshape(moved.shape).movedim(-1, axis)
