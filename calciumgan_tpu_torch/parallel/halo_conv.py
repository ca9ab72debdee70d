"""Sequence-parallel 1-D convolution with halo exchange (counterpart of
``calciumgan_tpu/parallel/halo_conv.py``).

A SAME-padded strided conv1d over an input whose time axis is split
between the ranks of a process group (the time axis of a run): each rank
holds ``(B, C, Ws)``, channels-first as the port's modules compute, and

1. receives its left neighbour's last frames as its left halo and its
   right neighbour's first frames as its right halo,
2. pads with zeros (SAME) or with its own reflection (phase shuffle) at
   the global boundaries,
3. runs a VALID conv over ``[left_halo | local | right_halo]``.

Alignment: with global width W, kernel K, stride s, SAME output ceil(W/s)
and total padding P = K - s (for W % s == 0), split L = P // 2. Output
element j reads inputs [j*s - L, j*s - L + K), so a shard of width Ws
(Ws % s == 0) needs a left halo of L and a right halo of K - s - L.

The exchange is linear; its adjoint sends each halo's gradient back to
the rank that owns those frames, where it is added in (and folds a
reflected edge's gradient back onto the frames it mirrors). Each is the
other's backward (:class:`_Exchange`, :class:`_ExchangeAdjoint`), so the
gradient penalty's second derivative runs through it. The frames travel by
one ``all_gather`` of every rank's two edges over the group: gloo gathers
CUDA tensors (through the host) and NCCL gathers them on the card, so one
code path serves both backends. A rank keeps its neighbours' edges of the
gathered ``T`` pairs; the edges are ``B x C x`` a few frames, so the extra
copies cost nothing beside the convolutions.

A ``group`` of None is one shard: both edges are global.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from calciumgan_tpu_torch.parallel import mesh as mesh_lib


def halo_sizes(kernel: int, stride: int) -> tuple:
    """(left, right) halo frames per shard for SAME conv."""
    if kernel < stride:
        return 0, 0
    total = kernel - stride
    left = total // 2
    return left, total - left


def _position(group) -> tuple:
    """(index, count) of this rank in ``group``; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _swap(to_right: torch.Tensor, to_left: torch.Tensor, group) -> tuple:
    """Send ``to_right`` to the right neighbour and ``to_left`` to the left
    one; returns (the left neighbour's ``to_right``, the right neighbour's
    ``to_left``), None where there is no neighbour."""
    idx, n = _position(group)
    if n == 1:
        return None, None
    pair = torch.cat([to_right.reshape(-1), to_left.reshape(-1)])
    parts = mesh_lib._all_gather(pair, group)
    split = to_right.numel()
    from_left = (parts[idx - 1][:split].view_as(to_right)
                 if idx > 0 else None)
    from_right = (parts[idx + 1][split:].view_as(to_left)
                  if idx < n - 1 else None)
    return from_left, from_right


def _exchange(x, left: int, right: int, edge_mode: str, group):
    idx, n = _position(group)
    from_left, from_right = _swap(x[..., x.shape[-1] - left:],
                                  x[..., :right], group)
    parts = []
    if left > 0:
        if from_left is None:  # the global left edge
            from_left = (x[..., 1:left + 1].flip(-1)
                         if edge_mode == "reflect"
                         else x.new_zeros(x.shape[:-1] + (left,)))
        parts.append(from_left)
    parts.append(x)
    if right > 0:
        if from_right is None:  # the global right edge
            width = x.shape[-1]
            from_right = (x[..., width - right - 1:width - 1].flip(-1)
                          if edge_mode == "reflect"
                          else x.new_zeros(x.shape[:-1] + (right,)))
        parts.append(from_right)
    return torch.cat(parts, dim=-1)


def _adjoint(g, left: int, right: int, edge_mode: str, group):
    """The transpose of :func:`_exchange`: ``g`` over ``[left | local |
    right]`` -> the gradient of ``local``."""
    idx, n = _position(group)
    width = g.shape[-1] - left - right
    g_left, g_right = g[..., :left], g[..., left + width:]
    # g_left belongs to the left neighbour's last frames, g_right to the
    # right neighbour's first: each goes back to its owner
    from_left, from_right = _swap(g_right, g_left, group)
    out = g[..., left:left + width].clone()
    if from_right is not None and left > 0:
        out[..., width - left:] += from_right
    if from_left is not None and right > 0:
        out[..., :right] += from_left
    if edge_mode == "reflect":  # a reflected edge mirrors our own frames
        if idx == 0 and left > 0:
            out[..., 1:left + 1] += g_left.flip(-1)
        if idx == n - 1 and right > 0:
            out[..., width - right - 1:width - 1] += g_right.flip(-1)
    return out


class _Exchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, left, right, edge_mode, group):
        ctx.args = (left, right, edge_mode, group)
        return _exchange(x, left, right, edge_mode, group)

    @staticmethod
    def backward(ctx, grad):
        return (_ExchangeAdjoint.apply(grad, *ctx.args),
                None, None, None, None)


class _ExchangeAdjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, g, left, right, edge_mode, group):
        ctx.args = (left, right, edge_mode, group)
        return _adjoint(g, left, right, edge_mode, group)

    @staticmethod
    def backward(ctx, grad):
        return (_Exchange.apply(grad, *ctx.args), None, None, None, None)


def exchange_halos(x_local: torch.Tensor, left: int, right: int, group,
                   edge_mode: str = "zero") -> torch.Tensor:
    """``[left_halo | local | right_halo]`` along the last axis of the
    rank's ``(B, C, Ws)`` shard. Global-boundary halos are zeros
    (``edge_mode='zero'``, SAME conv) or the local reflection
    (``'reflect'``, phase shuffle, as ``F.pad(mode='reflect')``: pad
    position j maps to x[pad - j]).

    Halos come from the IMMEDIATE neighbour only, so the shard width must
    cover the halo (a short shard raises, rather than read past its
    neighbour)."""
    if x_local.shape[-1] < max(left, right) + (1 if edge_mode == "reflect"
                                               else 0):
        raise ValueError(
            f"shard width {x_local.shape[-1]} smaller than halo "
            f"({left}, {right}): use fewer shards or longer sequences")
    if left == right == 0:
        return x_local
    return _Exchange.apply(x_local, left, right, edge_mode, group)


def halo_conv1d_local(x_local: torch.Tensor, weight: torch.Tensor,
                      stride: int, group) -> torch.Tensor:
    """The rank's output frames of the SAME strided conv with the port's
    ``(Cout, Cin, K)`` weight (no bias)."""
    K = weight.shape[-1]
    if K < stride:
        raise ValueError(f"kernel {K} < stride {stride} is unsupported")
    if x_local.shape[-1] % stride:
        raise ValueError(
            f"shard width {x_local.shape[-1]} not divisible by stride "
            f"{stride}: choose n_shards so every shard is stride-aligned")
    left, right = halo_sizes(K, stride)
    return F.conv1d(exchange_halos(x_local, left, right, group), weight,
                    stride=stride)


def _conv_transpose_same_padding(kernel: int, stride: int) -> tuple:
    """(pad_a, pad_b) on the input-dilated array for SAME transpose conv —
    the same split ``lax.conv_transpose`` computes (out = in * stride)."""
    pad_len = kernel + stride - 2
    if stride > kernel - 1:
        pad_a = kernel - 1
    else:
        pad_a = -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def halo_conv_transpose1d_local(x_local: torch.Tensor, weight: torch.Tensor,
                                stride: int, group) -> torch.Tensor:
    """The rank's output frames (``Ws * stride``) of the SAME transpose
    conv with the port's ``(Cin, Cout, K)`` K-flipped weight (no bias).

    The global op is a conv over the stride-dilated input padded by
    (pad_a, pad_b); a shard's outputs [t0*s, (t0+Ws)*s) read dilated
    positions [t0*s - pad_a, ...], i.e. input samples from ceil(pad_a/s)
    (left) / ceil(pad_b/s) (right) neighbour frames. The extension's full
    ``F.conv_transpose1d`` (no padding) holds XLA's VALID output from its
    frame K-1 on; the local window starts hl*s - pad_a further."""
    K = weight.shape[-1]
    pad_a, pad_b = _conv_transpose_same_padding(K, stride)
    hl = -(-pad_a // stride)
    hr = -(-pad_b // stride)
    width = x_local.shape[-1]
    full = F.conv_transpose1d(exchange_halos(x_local, hl, hr, group),
                              weight, stride=stride)
    return full.narrow(-1, K - 1 + hl * stride - pad_a, width * stride)
