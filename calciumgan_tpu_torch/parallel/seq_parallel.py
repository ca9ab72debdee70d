"""Sequence-parallel (context-parallel) CalciumGAN generator and
discriminator forwards (counterpart of
``calciumgan_tpu/parallel/seq_parallel.py``).

The full 1-D discriminator stack (5 x [SAME strided conv -> activation ->
phase shuffle] -> flatten -> Dense(1)) and the generator (Dense -> 5 x
[SAME transposed conv -> norm -> activation] -> Dense(C)) of
:mod:`calciumgan_tpu_torch.models.calciumgan`, with their own parameters,
over sequences whose TIME axis is split between the ranks of a group:

- each conv exchanges its (K - s)-frame halo, each transposed conv its
  ceil(pad/stride)-frame one (:mod:`.halo_conv`);
- phase shuffle exchanges an m-frame halo with *reflect* global edges and
  crops at the shifted offset: :func:`~calciumgan_tpu_torch.ops.
  phase_shuffle.phase_shuffle` of the whole sequence, one host-integer
  shift a call, the same on every rank;
- the O(seq) Dense(1) head is computed as per-rank partial dot products
  over the rank's contiguous rows of the time-major flatten, summed over
  the group (forward sum, gradient passed through: :func:`~.mesh.
  sum_over`). Its bias is added after the sum and takes its gradient on
  the group's first rank alone, so the time-axis sum of the gradients
  counts it once;
- the generator's input projection computes only this rank's ``w0/T``
  positions (a row block of the Dense weight); LayerNorm and the output
  Dense are per-position.

Each rank's parameter gradients are then its frames' share, which
:func:`~.mesh.gradient_mean` sums over the time axis. The modules' compute
dtype applies as in their own forwards (parameters float32, inputs and
parameters cast on use, norm statistics float32). Shard widths must stay
divisible by ``strides**5`` and cover each layer's halo; BatchNorm is
refused (its statistics would need a cross-shard reduction).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.parallel.halo_conv import (
    _position, exchange_halos, halo_conv1d_local,
    halo_conv_transpose1d_local)


def halo_phase_shuffle_local(x_local: torch.Tensor, shift: int, m: int,
                             group) -> torch.Tensor:
    """Global-sequence phase shuffle of the rank's ``(B, C, Ws)`` shard:
    every rank takes ``global_x[t + shift]`` for its own frames,
    reflect-indexed at the global edges; ``shift`` (in ``-m..m``) is the
    same on every rank."""
    if m == 0:
        return x_local
    width = x_local.shape[-1]
    if width <= m:
        raise ValueError(f"shard width {width} must exceed m={m}")
    if shift == 0:
        return x_local
    ext = exchange_halos(x_local, m, m, group, edge_mode="reflect")
    return ext[..., m + shift:m + shift + width]


def seq_parallel_discriminator(dis, x: torch.Tensor,
                               shifts: Optional[Sequence[int]],
                               group) -> torch.Tensor:
    """``dis`` (a calciumgan ``Discriminator``) over the rank's frames
    ``x`` ``(B, Ws, C)``; ``shifts`` one per shuffled layer, or None for
    none. Returns the ``(B, 1)`` float32 scores, the same on every rank of
    ``group``."""
    idx, _ = _position(group)
    dtype = dis.dtype
    h = x.transpose(1, 2).to(dtype)  # NWC -> NCW
    for i, conv in enumerate(dis.conv):
        h = halo_conv1d_local(h, conv.weight.to(dtype), conv.stride[0],
                              group)
        h = dis.act(h + conv.bias.to(dtype)[:, None])
        if shifts and i < len(shifts):
            h = halo_phase_shuffle_local(h, shifts[i], dis.m, group)
    # the flatten is (W, C) row-major, so rank idx owns the contiguous
    # input rows [idx*Ws*C, (idx+1)*Ws*C) of the head's kernel
    flat = h.transpose(1, 2).reshape(h.shape[0], -1)
    head = dis.dense
    k = flat.shape[1]
    part = F.linear(flat, head.weight.narrow(1, idx * k, k).to(dtype))
    # the other ranks add the same bias with a zero gradient
    bias = head.bias if idx == 0 else head.bias.detach() + 0.0 * head.bias
    out = mesh_lib.sum_over(part.float(), group).to(dtype) + bias.to(dtype)
    return out.float()


def seq_parallel_generator(gen, z: torch.Tensor, group) -> torch.Tensor:
    """``gen`` (a calciumgan ``Generator``) on the noise ``z`` ``(B,
    noise_dim)``, the same on every rank; returns the rank's frames
    ``(B, W/T, C)`` float32."""
    idx, n = _position(group)
    if gen.w0 % n:
        raise ValueError(f"w0={gen.w0} not divisible by {n} shards")
    dtype, nd = gen.dtype, gen.noise_dim
    cols = gen.w0 // n * nd
    d0 = gen.dense_0
    h = F.linear(z.to(dtype), d0.weight.narrow(0, idx * cols, cols).to(
        dtype)) + d0.bias.narrow(0, idx * cols, cols).to(dtype)
    h = gen.act(h).reshape(z.shape[0], cols // nd, nd).transpose(1, 2)
    for conv, norm in zip(gen.conv_transpose, gen.norm):
        if norm.batch_norm is not None:
            raise ValueError(
                "sequence-parallel generator does not support BatchNorm")
        h = halo_conv_transpose1d_local(h.to(dtype), conv.weight.to(dtype),
                                        conv.stride[0], group)
        h = gen.act(norm(h + conv.bias.to(dtype)[:, None]))
    h = gen.dense_1(h.transpose(1, 2)).float()
    return torch.sigmoid(h) if gen.normalize else h
