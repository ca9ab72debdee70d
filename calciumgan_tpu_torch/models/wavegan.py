"""WaveGAN at its published layout (Donahue, McAuley and Puckette,
"Adversarial Audio Synthesis", ICLR 2019, arXiv:1802.04208, Tables 1-3;
github.com/chrisdonahue/wavegan), registered as ``wavegan_paper``. The
``wavegan`` name stays the JAX package's alias of ``calciumgan``.

Model size ``d`` is ``--num_units``, the taps ``--kernel_size`` (25 in the
paper), the stride ``--strides`` (4) and the latent ``--noise_dim`` (100);
the channels of a sample ``c`` are the signals' (one per neuron). The
activations are the paper's, not ``--activation``'s, and there is no
normalisation (the paper's default):

Generator:
  z (noise_dim,) -> Dense(w0 * 16d) -> reshape (w0, 16d) -> ReLU
  -> 5 x ConvTranspose1D(K, s, SAME) with channels 8d, 4d, 2d, d, c, each
     followed by ReLU, the last by tanh (float32).
  ``w0 = T / s**5``: 16 frames of 1024 channels at d 64, T 16,384.
  Input ``(B, noise_dim)``, output NWC ``(B, T, c)`` float32 in [-1, 1].

Discriminator:
  5 x [Conv1D(K, s, SAME) with channels d, 2d, 4d, 8d, 16d -> LeakyReLU
       0.2 -> phase shuffle (layers 1-4, when m > 0)]
  -> flatten (time-major) -> Dense(1) -> float32.
  Input NWC ``(B, T, c)``, output ``(B, 1)`` float32.

The layers are :mod:`~calciumgan_tpu_torch.models.base`'s, named as the
1-D CalciumGAN's (``dense_0``, ``conv_transpose.i``; ``conv.i``,
``dense``), so :mod:`~calciumgan_tpu_torch.convert` carries Flax-layout
weights (``Dense_0``, ``ConvTranspose_i``; ``Conv_i``, ``Dense_0``) by the
same rules. At K 25 and stride 4 every critic layer pads asymmetrically
(10 frames left, 11 right: ``Conv`` prepends a zero tap to its kernel and
pads 11 frames on both sides, with no copy of its input) and every
generator layer crops a full transposed output (``K + s`` odd).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from calciumgan_tpu_torch.models import base
from calciumgan_tpu_torch.models.registry import register
from calciumgan_tpu_torch.ops.phase_shuffle import phase_shuffle

CRITIC_SLOPE = 0.2  # the paper's LeakyReLU


class Generator(nn.Module):

    def __init__(self, sequence_length: int, num_channels: int,
                 noise_dim: int = 100, num_units: int = 64,
                 kernel_size: int = 25, strides: int = 4,
                 dtype: torch.dtype = torch.float32, *,
                 rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.w0 = base.noise_width(sequence_length, strides)
        self.c0 = 16 * num_units
        self.dense_0 = base.Dense(noise_dim, self.w0 * self.c0, dtype, rng,
                                  device)
        convs, c_in = [], self.c0
        for f in [num_units * k for k in (8, 4, 2, 1)] + [num_channels]:
            convs.append(base.ConvTranspose(c_in, f, kernel_size, strides,
                                            dtype, rng, device))
            c_in = f
        self.conv_transpose = nn.ModuleList(convs)

    def draw_inputs(self, draws, batch: int, training: bool) -> tuple:
        """Nothing besides the noise: no dropout, no BatchNorm."""
        return ()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.dense_0(z).reshape(z.shape[0], self.w0, self.c0)
        x = F.relu(x.transpose(1, 2))
        *hidden, last = self.conv_transpose
        for conv in hidden:
            x = F.relu(conv(x))
        return torch.tanh(last(x).float()).transpose(1, 2)


class Discriminator(nn.Module):
    """``forward(x, shifts)`` takes the phase shifts of layers 1-4 from the
    caller, as the 1-D CalciumGAN critic does."""

    def __init__(self, sequence_length: int, num_channels: int,
                 num_units: int = 64, kernel_size: int = 25,
                 strides: int = 4, m: int = 2,
                 dtype: torch.dtype = torch.float32, *,
                 rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.m = m
        self.num_shifts = 4 if m > 0 else 0
        self.act = base.leaky_relu(CRITIC_SLOPE)
        convs, c_in, width = [], num_channels, sequence_length
        for k in (1, 2, 4, 8, 16):
            convs.append(base.Conv(c_in, num_units * k, kernel_size, strides,
                                   dtype, rng, device))
            c_in, width = num_units * k, -(-width // strides)
        self.conv = nn.ModuleList(convs)
        self.dense = base.Dense(width * c_in, 1, dtype, rng, device)

    def draw_inputs(self, draws, batch: int, training: bool) -> tuple:
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
        x = x.transpose(1, 2).reshape(x.shape[0], -1)  # time-major
        return self.dense(x).float()


@register("wavegan_paper")
def build(config, rng: torch.Generator, device=None):
    if config.batch_norm or config.layer_norm:
        raise ValueError("wavegan_paper has no normalisation layers: drop "
                         "--batch_norm and --layer_norm")
    dtype = torch.bfloat16 if config.mixed_precision else torch.float32
    gen = Generator(
        sequence_length=config.signal_shape[0],
        num_channels=config.num_channels,
        noise_dim=config.noise_dim,
        num_units=config.num_units,
        kernel_size=config.kernel_size,
        strides=config.strides,
        dtype=dtype, rng=rng, device=device)
    dis = Discriminator(
        sequence_length=config.signal_shape[0],
        num_channels=config.signal_shape[-1],
        num_units=config.num_units,
        kernel_size=config.kernel_size,
        strides=config.strides,
        m=config.m,
        dtype=dtype, rng=rng, device=device)
    return gen, dis
