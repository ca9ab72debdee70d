"""MLP generator and discriminator (counterpart of
``calciumgan_tpu/models/mlp.py``), the model the surrogate set trains.

Generator: Dense(seq*noise_dim) -> act -> reshape (seq, noise_dim) -> 3 x
[Dense(u*{1,2,3}) -> act -> dropout] -> Dense(C) -> float32 -> sigmoid
(normalised data) else linear. Input ``(B, noise_dim)``, output NWC ``(B,
seq, C)``.

Discriminator: 4 x [Dense(u*{4,3,2,1}) -> act -> dropout] -> flatten ->
Dense(1) float32. Input NWC ``(B, W, C)``, output ``(B, 1)``. The Dense
layers act on the last axis, so nothing is transposed and the flatten is
time-major as in the JAX package.

Dropout is Flax's: a keep mask drawn ``bernoulli(1 - rate)`` per element
and ``where(keep, x / (1 - rate), 0)``: a division by the keep probability
rounded to the compute dtype, not a product by its reciprocal (the two
round differently in bfloat16). The masks are an argument of ``forward``,
drawn by the caller (``draw_inputs``) from the step's
:class:`~calciumgan_tpu_torch.algorithms.gan.Draws`; ``masks=None`` is
evaluation, without dropout. There is no ``train()``/``eval()`` state.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from calciumgan_tpu_torch.models import base
from calciumgan_tpu_torch.models.registry import register


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
            rate: float) -> torch.Tensor:
    """Flax ``nn.Dropout`` on ``x`` with the boolean keep mask ``keep``
    (rate 1 keeps nothing and takes no mask)."""
    if rate == 1.0:
        return torch.zeros_like(x)
    return torch.where(keep, x / base._in_dtype(1.0 - rate, x.dtype),
                       torch.zeros_like(x))


class _DropoutNet(nn.Module):
    """A net whose hidden layers of ``widths`` units over
    ``sequence_length`` frames each end in dropout at ``rate``."""

    def draw_inputs(self, draws, batch: int, training: bool) -> tuple:
        """What ``forward`` takes besides its input, for one pass over
        ``batch`` rows: ``(masks,)``, the keep masks in layer order; None
        in evaluation and at rate 0, where Flax returns its input and
        draws nothing."""
        if not training or self.rate == 0.0:
            return (None,)
        if self.rate == 1.0:
            return ([None] * len(self.widths),)
        return ([draws.dropout((batch, self.sequence_length, w), self.rate)
                 for w in self.widths],)


class GeneratorMLP(_DropoutNet):

    def __init__(self, sequence_length: int, num_channels: int,
                 noise_dim: int = 32, num_units: int = 32,
                 dropout: float = 0.2, activation: str = "leakyrelu",
                 normalize: bool = True, dtype: torch.dtype = torch.float32,
                 *, rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.sequence_length = sequence_length
        self.noise_dim = noise_dim
        self.rate = float(dropout)
        self.normalize = normalize
        self.act = base.activation(activation)
        self.widths = [num_units * k for k in (1, 2, 3)]
        sizes = [noise_dim] + self.widths + [num_channels]
        # named as Flax names them: Dense_0 .. Dense_4
        self.dense_0 = base.Dense(noise_dim, sequence_length * noise_dim,
                                  dtype, rng, device)
        for i in range(4):
            setattr(self, f"dense_{i + 1}", base.Dense(
                sizes[i], sizes[i + 1], dtype, rng, device))

    def forward(self, z: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        x = self.act(self.dense_0(z))
        x = x.reshape(x.shape[0], self.sequence_length, self.noise_dim)
        for i in range(3):
            x = self.act(getattr(self, f"dense_{i + 1}")(x))
            if masks is not None:
                x = dropout(x, masks[i], self.rate)
        x = self.dense_4(x).float()
        return torch.sigmoid(x) if self.normalize else x


class DiscriminatorMLP(_DropoutNet):

    def __init__(self, sequence_length: int, num_channels: int,
                 num_units: int = 32, dropout: float = 0.2,
                 activation: str = "leakyrelu",
                 dtype: torch.dtype = torch.float32, *,
                 rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.sequence_length = sequence_length
        self.rate = float(dropout)
        self.act = base.activation(activation)
        self.widths = [num_units * k for k in (4, 3, 2, 1)]
        sizes = [num_channels] + self.widths
        for i in range(4):
            setattr(self, f"dense_{i}", base.Dense(
                sizes[i], sizes[i + 1], dtype, rng, device))
        # Flax infers Dense_4's input (frames x units) from the data
        self.dense_4 = base.Dense(sequence_length * sizes[-1], 1, dtype, rng,
                                  device)

    def forward(self, x: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        for i in range(4):
            x = self.act(getattr(self, f"dense_{i}")(x))
            if masks is not None:
                x = dropout(x, masks[i], self.rate)
        x = x.reshape(x.shape[0], -1)
        return self.dense_4(x).float()


@register("mlp")
def build(config, rng: torch.Generator, device=None):
    dtype = torch.bfloat16 if config.mixed_precision else torch.float32
    gen = GeneratorMLP(
        sequence_length=config.signal_shape[0],
        num_channels=config.num_channels,
        noise_dim=config.noise_dim,
        num_units=config.num_units,
        dropout=config.dropout,
        activation=config.activation,
        normalize=config.normalize,
        dtype=dtype, rng=rng, device=device)
    dis = DiscriminatorMLP(
        sequence_length=config.signal_shape[0],
        num_channels=config.signal_shape[-1],
        num_units=config.num_units,
        dropout=config.dropout,
        activation=config.activation,
        dtype=dtype, rng=rng, device=device)
    return gen, dis
