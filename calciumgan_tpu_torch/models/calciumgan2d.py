"""CalciumGAN-2D generator and discriminator, which treat (time, neuron) as
an image plane (counterpart of ``calciumgan_tpu/models/calciumgan2d.py``;
used with ``--conv2d`` datasets, whose signals are ``(T, N, 1|2)``).

Generator (``:29-65``):
  noise -> Dense(w0 * N/2 * noise_dim) -> act -> reshape (w0, N/2, noise_dim)
  -> 5 x [ConvTranspose2D(filters, (k, k), (s, 2 if layer 2 else 1), SAME)
          -> norm -> act] with filters [5u, 3u, 2u, u, C] (not the 1-D
     ladder); the norm and activation follow the last layer too, where a
     single channel skips the LayerNorm but not the BatchNorm
  -> Dense(C) -> float32 -> sigmoid (normalised data) else linear.
  Input ``(B, noise_dim)``, output NHWC ``(B, T, N, C)`` float32.

Discriminator (``:68-88``):
  5 x [Conv2D(u * {1..5}, (16, 16), (4, 1), SAME) -> act
       -> 2-D phase shuffle after layers 0-3: time by ``m`` on layers 0-2
          and 0 on layer 3 (the reference's quirk), neurons by ``n``]
  -> flatten (time, neuron, channel) -> Dense(1) -> float32.
  Input NHWC ``(B, T, N, C)``, output ``(B, 1)`` float32.

Inside, both stacks run in NCHW; the discriminator permutes its last map
back to NHWC before it flattens, so ``Dense_0``'s kernel carries over by a
plain transpose (:mod:`calciumgan_tpu_torch.convert`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from calciumgan_tpu_torch.models import base
from calciumgan_tpu_torch.models.registry import register
from calciumgan_tpu_torch.ops.phase_shuffle import phase_shuffle_2d

CRITIC_KERNEL, CRITIC_STRIDES = (16, 16), (4, 1)


class Generator2D(nn.Module):

    def __init__(self, sequence_length: int, num_neurons: int,
                 num_channels: int, noise_dim: int = 32, num_units: int = 32,
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
        self.c0 = num_neurons // 2

        self.dense_0 = base.Dense(noise_dim, self.w0 * self.c0 * noise_dim,
                                  dtype, rng, device)
        filters = [num_units * k for k in (5, 3, 2, 1)] + [num_channels]
        convs, norms = [], []
        c_in = noise_dim
        for i, f in enumerate(filters):
            convs.append(base.ConvTranspose(
                c_in, f, (kernel_size, kernel_size),
                (strides, 2 if i == 2 else 1), dtype, rng, device))
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
        x = x.reshape(x.shape[0], self.w0, self.c0,
                      self.noise_dim).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv, norm in zip(self.conv_transpose, self.norm):
            x = self.act(norm(conv(x), training))
        x = self.dense_1(x.permute(0, 2, 3, 1)).float()
        return torch.sigmoid(x) if self.normalize else x


class Discriminator2D(nn.Module):
    """``forward(x, shifts)`` takes one ``(time, neuron)`` pair of phase
    shifts for each of layers 0-3, drawn by :meth:`draw_inputs` in the JAX
    module's order (time then neuron, layer by layer; an axis whose bound
    is 0 draws nothing and its entry is 0), in training and evaluation
    alike."""

    def __init__(self, sequence_length: int, num_neurons: int,
                 num_channels: int, num_units: int = 32, m: int = 2,
                 n: int = 2, activation: str = "leakyrelu",
                 dtype: torch.dtype = torch.float32, *,
                 rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.n = n
        # the time bound of each shuffled layer (calciumgan2d.py:82)
        self.layer_m = (m, m, m, 0)
        self.act = base.activation(activation)
        convs = []
        c_in, width = num_channels, sequence_length
        for k in (1, 2, 3, 4, 5):
            convs.append(base.Conv(c_in, num_units * k, CRITIC_KERNEL,
                                   CRITIC_STRIDES, dtype, rng, device))
            c_in, width = num_units * k, -(-width // CRITIC_STRIDES[0])
        self.conv = nn.ModuleList(convs)
        # Flax infers Dense_0's input (frames x neurons x channels) from
        # the data; here it follows from the signal shape
        self.dense = base.Dense(width * num_neurons * c_in, 1, dtype, rng,
                                device)

    def draw_inputs(self, draws, batch: int, training: bool) -> tuple:
        """What ``forward`` takes besides the signals: ``(shifts,)``."""
        shifts = []
        for m in self.layer_m:
            pair = [draws.shifts(bound, 1 if bound > 0 else 0)
                    for bound in (m, self.n)]
            shifts.append(tuple(d[0] if d else 0 for d in pair))
        return (shifts,)

    def forward(self, x: torch.Tensor,
                shifts: Sequence[Tuple[int, int]]) -> torch.Tensor:
        if len(shifts) != len(self.layer_m):
            raise ValueError(f"the discriminator takes {len(self.layer_m)} "
                             f"(time, neuron) shift pairs, got {len(shifts)}")
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i, conv in enumerate(self.conv):
            x = self.act(conv(x))
            if i < len(self.layer_m):
                x = phase_shuffle_2d(x, shifts[i], self.layer_m[i], self.n)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # as JAX flattens
        return self.dense(x).float()


@register("calciumgan2d")
def build(config, rng: torch.Generator, device=None):
    num_neurons = config.signal_shape[1]
    if num_neurons % 2:
        # the generator seeds the neuron axis at num_neurons // 2 and
        # doubles it with a stride-2 layer (calciumgan2d.py:93-100)
        raise ValueError(
            f"calciumgan2d requires an even neuron count, got {num_neurons}")
    dtype = torch.bfloat16 if config.mixed_precision else torch.float32
    gen = Generator2D(
        sequence_length=config.signal_shape[0],
        num_neurons=num_neurons,
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
    dis = Discriminator2D(
        sequence_length=config.signal_shape[0],
        num_neurons=num_neurons,
        num_channels=config.signal_shape[-1],
        num_units=config.num_units,
        m=config.m,
        n=config.n,
        activation=config.activation,
        dtype=dtype, rng=rng, device=device)
    return gen, dis
