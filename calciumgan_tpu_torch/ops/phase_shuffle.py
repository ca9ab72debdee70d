"""WaveGAN phase shuffle (copy of ``phase_shuffle`` and ``_shift_axis`` in
``calciumgan_tpu/ops/phase_shuffle.py:24-63``).

One shift per call, shared by the whole batch: the feature map is
reflect-padded by ``m`` (edge excluded, as ``jnp.pad(mode="reflect")`` and
``F.pad(mode="reflect")`` both pad) and cropped back at offset ``m +
shift``. Pad and shift are clamped to ``width - 1`` so tiny feature maps
saturate instead of failing.

The shift is a slice offset, so it is a host integer: :func:`draw_shifts`
draws it from a CPU ``torch.Generator`` (a draw on the card would cost a
synchronisation per layer), and callers may pass shifts in explicitly, which
is how the tests replay the JAX package's draws. ``phase_shuffle_2d`` comes
with the ``calciumgan2d`` model.
"""

from __future__ import annotations

from typing import List

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
    # F.pad's reflect mode pads the last axis of a 3-D (N, C, W) tensor;
    # its CUDA kernel puts N and C on grid axes of at most 65,535 blocks,
    # so the leading axes stay split (the discriminator's (B, C, W) as is)
    moved = x.movedim(axis, -1)
    lead = moved.shape[:-1]
    flat = moved.reshape(lead[0] if len(lead) > 1 else 1, -1, width)
    padded = F.pad(flat, (m, m), mode="reflect")
    out = padded[..., m + shift:m + shift + width]
    return out.reshape(*lead, width).movedim(-1, axis)
