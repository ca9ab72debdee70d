"""Shared building blocks (counterpart of ``calciumgan_tpu/models/base.py``).

Keras-parity choices kept from the JAX package (``base.py:3-9``):

- glorot_uniform kernel init and zero bias, drawn from an explicit
  ``torch.Generator`` (this overrides PyTorch's default Kaiming init); a
  conv kernel's fans count its receptive field (``K*Cin``, ``K*Cout``),
- LeakyReLU slope 0.3,
- LayerNorm epsilon 1e-3 over the channel axis with Flax's fast variance
  ``E[x^2] - E[x]^2``, skipped when that axis has size 1 (``base.py:45-70``).

Mixed precision follows Flax, not autocast: each module carries its compute
``dtype`` as an attribute, keeps float32 parameters and casts inputs and
parameters to ``dtype`` on use. LayerNorm statistics are float32.

Layout: modules compute in NCW (batch, channel, time); the models' public
boundary is NWC (:mod:`calciumgan_tpu_torch.models.calciumgan`). Flax kernel
layouts are converted by :mod:`calciumgan_tpu_torch.convert`.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-3


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar that
    meets an array of that dtype (0.3 is 0.30078125 in bfloat16)."""
    return float(torch.tensor(value, dtype=dtype))


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(
            x, negative_slope=_in_dtype(0.3, x.dtype))
    if name == "linear":
        return lambda x: x
    return getattr(F, name)


def noise_width(sequence_length: int, strides: int,
                num_convolutions: int = 5) -> int:
    """Validated initial temporal width of the transpose-conv stack
    (``calciumgan_tpu/models/base.py:73-83``)."""
    w = sequence_length / (strides ** num_convolutions)
    if not float(w).is_integer():
        raise ValueError(
            f"sequence_length {sequence_length} not divisible by "
            f"strides**{num_convolutions} ({strides ** num_convolutions}); "
            f"w={w} is not an integer")
    return int(w)


def glorot_uniform_(weight: torch.Tensor, fan_in: int, fan_out: int,
                    rng: torch.Generator) -> torch.Tensor:
    """In-place U(-a, a), a = sqrt(6 / (fan_in + fan_out)), drawn on the
    generator's device and copied to the weight's."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    draw = torch.rand(weight.shape, generator=rng, device=rng.device)
    with torch.no_grad():
        weight.copy_(draw * (2.0 * limit) - limit)
    return weight


class Dense(nn.Module):
    """``nn.Dense`` over the last axis; weight stored ``(out, in)``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        glorot_uniform_(self.weight, in_features, out_features, rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bias added after the product, as Flax does (two roundings in bf16)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)


def same_conv_padding(width: int, kernel_size: int, stride: int) -> tuple:
    """(pad_lo, pad_hi) of XLA's SAME convolution: the output has
    ``ceil(W/s)`` frames, the padding totals ``max((ceil(W/s)-1)*s + K - W,
    0)`` and its floor half goes on the left, so it is asymmetric when the
    total is odd."""
    out = -(-width // stride)
    total = max((out - 1) * stride + kernel_size - width, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax ``nn.Conv`` with padding SAME and stride ``s``, in NCW; weight
    stored ``(Cout, Cin, K)``. ``F.conv1d`` is a correlation, as
    ``lax.conv`` is, so the Flax kernel is not flipped. Torch's
    ``padding="same"`` rejects stride > 1, so the SAME padding of
    :func:`same_conv_padding` is given explicitly."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, dtype: torch.dtype, rng: torch.Generator,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        glorot_uniform_(self.weight, kernel_size * in_channels,
                        kernel_size * out_channels, rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        lo, hi = same_conv_padding(x.shape[-1], self.kernel_size,
                                   self.stride)
        if lo == hi:
            y = F.conv1d(x, self.weight.to(self.dtype), stride=self.stride,
                         padding=lo)
        else:
            y = F.conv1d(F.pad(x, (lo, hi)), self.weight.to(self.dtype),
                         stride=self.stride)
        # bias added after the convolution, as Flax does
        return y + self.bias.to(self.dtype)[:, None]


def same_transpose_padding(kernel_size: int, stride: int) -> tuple:
    """(pad_a, pad_b) that ``lax.conv_transpose`` gives padding SAME on the
    dilated input: ``pad_len = K+s-2``, ``pad_a = K-1`` if ``s > K-1`` else
    ``ceil(pad_len/2)``. The output length is ``W*s``."""
    pad_len = kernel_size + stride - 2
    pad_a = (kernel_size - 1 if stride > kernel_size - 1
             else -(-pad_len // 2))
    return pad_a, pad_len - pad_a


class ConvTranspose(nn.Module):
    """Flax ``nn.ConvTranspose`` with padding SAME, in NCW.

    Flax does not flip its kernel (``transpose_kernel=False``) and
    ``F.conv_transpose1d`` does, so the weight is stored ``(Cin, Cout, K)``
    already K-flipped (see :mod:`calciumgan_tpu_torch.convert`). Flax's
    output frame ``o`` is PyTorch's frame ``o`` at ``padding = K-1-pad_a``;
    the end gets ``output_padding = pad_b - pad_a`` frames (``s-K`` when
    ``s > K-1``, else 0 or -1). When that is -1 (odd ``K+s``), PyTorch's
    padding would take the frame from the wrong side, so the full (padding
    0) output is cropped instead."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, dtype: torch.dtype, rng: torch.Generator,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        glorot_uniform_(self.weight, kernel_size * in_channels,
                        kernel_size * out_channels, rng)
        pad_a, pad_b = same_transpose_padding(kernel_size, stride)
        self.padding = kernel_size - 1 - pad_a
        self.output_padding = pad_b - pad_a
        self.crop = self.output_padding < 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.crop:
            width = x.shape[-1] * self.stride
            y = F.conv_transpose1d(x, w, stride=self.stride)
            y = y[..., self.padding:self.padding + width]
        else:
            y = F.conv_transpose1d(x, w, stride=self.stride,
                                   padding=self.padding,
                                   output_padding=self.output_padding)
        # bias added after the convolution, as Flax does
        return y + self.bias.to(self.dtype)[:, None]


class Norm(nn.Module):
    """LayerNorm over the channel axis of NCW input (``base.py:45-70``).
    BatchNorm is not ported yet: the flagship recipe uses layer_norm."""

    def __init__(self, channels: int, batch_norm: bool = False,
                 layer_norm: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if batch_norm:
            raise NotImplementedError(
                "batch_norm is not ported to calciumgan_tpu_torch yet "
                "(ROADMAP Queue 1)")
        self.dtype = dtype
        self.layer_norm = layer_norm and channels > 1
        if self.layer_norm:
            self.scale = nn.Parameter(torch.ones(channels, device=device))
            self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.layer_norm:
            return x
        x32 = x.float()
        inv_n = float(torch.tensor(1.0 / x.shape[1]))  # XLA's mean: sum*(1/n)
        mean = x32.sum(1, keepdim=True) * inv_n
        var = ((x32 * x32).sum(1, keepdim=True) * inv_n
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * self.scale[:, None]
        y = (x32 - mean) * mul + self.bias[:, None]
        return y.to(self.dtype)
