"""What the harness makes from ``--seed`` and hands to both the program and
the reference: weights in Flax's layout, AR(1) calcium training windows,
each step's random draws and the epochs' batch order.

Everything is drawn on the run's device from ``torch.Generator``s seeded by
:func:`derive`, in a few large calls, so one seed gives the same inputs on
every run and ``--seed`` may be any whole number, also past 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference import model

BIAS_SPAN = 0.05   # biases uniform on +-0.05
SCALE_SPAN = 0.1   # LayerNorm scales uniform on 1 +- 0.1


def entropy(seed: int) -> int:
    """``--seed`` as the unsigned 64-bit entropy numpy's seeding takes (the
    same number for every seed from 0 to 2**64 - 1)."""
    return int(seed) % (1 << 64)


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for the stream ``tags`` of run ``seed``."""
    state = np.random.SeedSequence([entropy(seed), *tags]).generate_state(
        2, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator_on(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def weights(shapes: dict, seed: int, tag: int, device) -> dict:
    """``{flax path: float32 tensor}`` for ``shapes``: kernels glorot-uniform,
    biases uniform on +-BIAS_SPAN, LayerNorm scales on 1 +- SCALE_SPAN, all
    from one uniform draw on ``device``."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=generator_on(device, seed, tag),
                      device=device) * 2.0 - 1.0
    out = {}
    for (path, shape), part in zip(shapes.items(),
                                   torch.split(flat, sizes)):
        part = part.reshape(shape)
        if path.endswith("/kernel"):
            fan_in, fan_out = model.fan(path, shape)
            part = part * math.sqrt(6.0 / (fan_in + fan_out))
        elif path.endswith("/scale"):
            part = 1.0 + SCALE_SPAN * part
        else:
            part = BIAS_SPAN * part
        out[path] = part.contiguous()
    return out


def model_weights(cfg: dict, seed: int, device) -> tuple:
    """The generator's and the critic's weights of run ``seed``."""
    return (weights(model.generator_shapes(cfg), seed, 1, device),
            weights(model.critic_shapes(cfg), seed, 2, device))


def to_numpy_tree(flat: dict) -> dict:
    """Flat device weights -> the nested host arrays Flax variables are."""
    return model.nest({k: v.detach().cpu().numpy() for k, v in flat.items()})


def ar1_calcium(rows: int, T: int, C: int, params: dict, seed: int,
                device) -> torch.Tensor:
    """``(rows, T, C)`` float32 windows of AR(1) calcium: Bernoulli spikes of
    ``rate`` a frame, ``c[t] = g*c[t-1] + s[t]``, plus Gaussian noise of
    scale ``noise``, then min-max normalised to [0, 1] as the training
    records are."""
    gen = generator_on(device, seed, 3)
    spikes = (torch.rand((T, rows * C), generator=gen, device=device)
              < params["rate"]).float()
    calcium = torch.empty_like(spikes)
    acc = torch.zeros(rows * C, device=device)
    for t in range(T):
        acc = params["g"] * acc + spikes[t]
        calcium[t] = acc
    calcium += params["noise"] * torch.randn(calcium.shape, generator=gen,
                                             device=device)
    calcium = calcium.reshape(T, rows, C).permute(1, 0, 2).contiguous()
    lo, hi = calcium.amin(), calcium.amax()
    return (calcium - lo) / (hi - lo)


def epoch_order(seed: int, epoch: int, rows: int, batch: int) -> list:
    """The row indices of each of ``epoch``'s batches: ``rows`` shuffled by
    a generator seeded from ``(seed, epoch)``, the remainder dropped (the
    training loop's rule)."""
    order = np.arange(rows)
    np.random.default_rng([entropy(seed), 4, epoch]).shuffle(order)
    return [order[i * batch:(i + 1) * batch] for i in range(rows // batch)]


def step_rows(seed: int, step: int, rows: int, batch: int) -> np.ndarray:
    """The rows of training step ``step`` (epochs of ``rows // batch``
    steps)."""
    per = rows // batch
    return epoch_order(seed, step // per, rows, batch)[step % per]


class Draws:
    """The random numbers of one training step, with the methods the
    program's steps call: noise and alpha from two generators on the
    device, phase shifts from one on the host, each seeded from ``(seed,
    step)``. A second object of the same ``(seed, step)`` draws the same
    numbers in the same order of calls."""

    def __init__(self, seed: int, step: int, device):
        self.device = torch.device(device)
        self._noise = generator_on(self.device, seed, 5, step)
        self._alpha = generator_on(self.device, seed, 6, step)
        self._shifts = torch.Generator().manual_seed(derive(seed, 7, step))

    def noise(self, n: int, noise_dim: int) -> torch.Tensor:
        return torch.randn((n, noise_dim), generator=self._noise,
                           device=self.device)

    def alpha(self, n: int) -> torch.Tensor:
        return torch.rand((n,), generator=self._alpha, device=self.device)

    def shifts(self, m: int, count: int) -> list:
        if m <= 0 or count == 0:
            return []
        return torch.randint(-m, m + 1, (count,),
                             generator=self._shifts).tolist()

