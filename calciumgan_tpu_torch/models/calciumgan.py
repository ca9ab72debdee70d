"""CalciumGAN (1-D WaveGAN-style) generator and discriminator (counterpart
of ``calciumgan_tpu/models/calciumgan.py``).

Generator (``:31-64``):
  noise (noise_dim,) -> Dense(w0*noise_dim) -> act -> reshape (w0, noise_dim)
  -> 5 x [ConvTranspose1D(filters, kernel, stride, SAME) -> norm -> act]
     with filters [5u, 4u, 3u, 2u, C]
  -> Dense(C) -> float32 -> sigmoid (normalised data) else linear.
  Input ``(B, noise_dim)``, output NWC ``(B, sequence_length, C)`` float32.
  ``forward(z, training)``: a training pass normalises a ``--batch_norm``
  net by its batch statistics and moves the running ones; evaluation
  (the default) reads the running ones.

Discriminator (``:67-89``):
  5 x [Conv1D(filters [u, 2u, 3u, 4u, 5u], kernel, stride, SAME) -> act
       -> phase shuffle (layers 1-4, when m > 0)]
  -> flatten -> Dense(1) -> float32.
  Input NWC ``(B, W, C)``, output ``(B, 1)`` float32.

Inside, both conv stacks run in NCW. JAX flattens the NWC map ``(B, W', C')``
time-major; the discriminator transposes its last map back to NWC before it
flattens, so ``Dense_0``'s kernel carries over by a plain transpose
(:mod:`calciumgan_tpu_torch.convert`) at the cost of one copy of a small map.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from calciumgan_tpu_torch.models import base
from calciumgan_tpu_torch.models.registry import register
from calciumgan_tpu_torch.ops.phase_shuffle import phase_shuffle


class Generator(nn.Module):

    def __init__(self, sequence_length: int, num_channels: int,
                 noise_dim: int = 32, num_units: int = 32,
                 kernel_size: int = 24, strides: int = 2,
                 activation: str = "leakyrelu", batch_norm: bool = False,
                 layer_norm: bool = False, normalize: bool = True,
                 dtype: torch.dtype = torch.float32, *,
                 rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.noise_dim = noise_dim
        self.normalize = normalize
        self.act = base.activation(activation)
        self.w0 = base.noise_width(sequence_length, strides)

        self.dense_0 = base.Dense(noise_dim, self.w0 * noise_dim, dtype, rng,
                                  device)
        filters = [num_units * k for k in (5, 4, 3, 2)] + [num_channels]
        convs, norms = [], []
        c_in = noise_dim
        for f in filters:
            convs.append(base.ConvTranspose(c_in, f, kernel_size, strides,
                                            dtype, rng, device))
            norms.append(base.Norm(f, batch_norm, layer_norm, dtype, device))
            c_in = f
        self.conv_transpose = nn.ModuleList(convs)
        self.norm = nn.ModuleList(norms)
        self.dense_1 = base.Dense(num_channels, num_channels, dtype, rng,
                                  device)

    def draw_inputs(self, draws, batch: int, training: bool) -> tuple:
        """What ``forward`` takes besides the noise: ``(training,)``, which
        only a BatchNorm reads; nothing is drawn."""
        return (training,)

    def forward(self, z: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        x = self.act(self.dense_0(z))
        x = x.reshape(x.shape[0], self.w0, self.noise_dim).transpose(1, 2)
        for conv, norm in zip(self.conv_transpose, self.norm):
            x = self.act(norm(conv(x), training))
        x = self.dense_1(x.transpose(1, 2)).float()
        return torch.sigmoid(x) if self.normalize else x


class Discriminator(nn.Module):
    """``forward(x, shifts)`` takes the phase-shuffle shifts of layers 1-4
    (:attr:`num_shifts` of them, drawn from ``-m..m``) from the caller: the
    JAX module draws them from its ``phase`` RNG collection in training and
    evaluation alike, and so does every caller here."""

    def __init__(self, sequence_length: int, num_channels: int,
                 num_units: int = 32, kernel_size: int = 24,
                 strides: int = 2, m: int = 2,
                 activation: str = "leakyrelu",
                 dtype: torch.dtype = torch.float32, *,
                 rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.m = m
        self.num_shifts = 4 if m > 0 else 0
        self.act = base.activation(activation)
        convs = []
        c_in, width = num_channels, sequence_length
        for k in (1, 2, 3, 4, 5):
            convs.append(base.Conv(c_in, num_units * k, kernel_size, strides,
                                   dtype, rng, device))
            c_in, width = num_units * k, -(-width // strides)
        self.conv = nn.ModuleList(convs)
        # Flax infers Dense_0's input (last map's frames x channels) from
        # the data; here it follows from the sequence length
        self.dense = base.Dense(width * c_in, 1, dtype, rng, device)

    def draw_inputs(self, draws, batch: int, training: bool) -> tuple:
        """What ``forward`` takes besides the signals: ``(shifts,)``, drawn
        in training and evaluation alike."""
        return (draws.shifts(self.m, self.num_shifts),)

    def forward(self, x: torch.Tensor,
                shifts: Sequence[int] = ()) -> torch.Tensor:
        if len(shifts) != self.num_shifts:
            raise ValueError(f"the discriminator takes {self.num_shifts} "
                             f"phase shifts, got {len(shifts)}")
        x = x.transpose(1, 2)  # NWC -> NCW
        for i, conv in enumerate(self.conv):
            x = self.act(conv(x))
            if i < self.num_shifts:
                x = phase_shuffle(x, shifts[i], self.m, axis=-1)
        x = x.transpose(1, 2).reshape(x.shape[0], -1)  # time-major, as JAX
        return self.dense(x).float()


@register("calciumgan")
def build(config, rng: torch.Generator, device=None):
    dtype = torch.bfloat16 if config.mixed_precision else torch.float32
    gen = Generator(
        sequence_length=config.signal_shape[0],
        num_channels=config.num_channels,
        noise_dim=config.noise_dim,
        num_units=config.num_units,
        kernel_size=config.kernel_size,
        strides=config.strides,
        activation=config.activation,
        batch_norm=config.batch_norm,
        layer_norm=config.layer_norm,
        normalize=config.normalize,
        dtype=dtype, rng=rng, device=device)
    dis = Discriminator(
        sequence_length=config.signal_shape[0],
        num_channels=config.signal_shape[-1],
        num_units=config.num_units,
        kernel_size=config.kernel_size,
        strides=config.strides,
        m=config.m,
        activation=config.activation,
        dtype=dtype, rng=rng, device=device)
    return gen, dis
