"""CalciumGAN (1-D WaveGAN-style) generator (counterpart of
``calciumgan_tpu/models/calciumgan.py:31-64``).

  noise (noise_dim,) -> Dense(w0*noise_dim) -> act -> reshape (w0, noise_dim)
  -> 5 x [ConvTranspose1D(filters, kernel, stride, SAME) -> norm -> act]
     with filters [5u, 4u, 3u, 2u, C]
  -> Dense(C) -> float32 -> sigmoid (normalised data) else linear.

Input ``(B, noise_dim)``, output NWC ``(B, sequence_length, C)`` float32;
inside, the conv stack runs in NCW. The discriminator is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from calciumgan_tpu_torch.models import base
from calciumgan_tpu_torch.models.registry import register


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

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.act(self.dense_0(z))
        x = x.reshape(x.shape[0], self.w0, self.noise_dim).transpose(1, 2)
        for conv, norm in zip(self.conv_transpose, self.norm):
            x = self.act(norm(conv(x)))
        x = self.dense_1(x.transpose(1, 2)).float()
        return torch.sigmoid(x) if self.normalize else x


@register("calciumgan")
def build(config, rng: torch.Generator, device=None) -> Generator:
    dtype = torch.bfloat16 if config.mixed_precision else torch.float32
    return Generator(
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
