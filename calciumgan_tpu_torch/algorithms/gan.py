"""Vanilla (non-saturating) GAN with BCE-from-logits losses (counterpart of
``calciumgan_tpu/algorithms/gan.py``).

The JAX package's steps are pure ``(state, batch, key) -> (state, logs)``
functions; here a step updates the :class:`~.state.GANState` in place and
returns its logs as device tensors (no host synchronisation per step).
Behaviours kept:

- both gradients of the vanilla GAN come from ONE forward pass: the same
  noise and phase shifts, real and fake through one discriminator pass over
  ``concat(real, fake)`` (``gan.py:154-209``); each loss is differentiated
  w.r.t. its own net only, so neither optimizer sees the other's loss;
- Adam with ``eps=1e-7`` (:mod:`.state`), no loss scaling under bf16;
- per-batch signal metrics on denormalised data (``gan.py:110-112``);
- the generator EMA is a side-car: updated after each generator step, used
  by evaluation and sampling, never by training (``gan.py:56-64,97-103``).
  It averages parameters only: sampling pairs it with the generator's
  BatchNorm running statistics, the module's buffers;
- a ``--batch_norm`` generator moves its running statistics once per
  training pass: once a step here, as the JAX step keeps the statistics of
  one of its two identical passes (``gan.py:182-197``); evaluation,
  sampling and generation read them (``training=False``).

Randomness comes from a :class:`Draws`, one per step: noise, GP alpha and
dropout masks from a ``torch.Generator`` on the device, phase shifts from
one on the host, both seeded from ``(seed, counter)``. JAX's threefry and
PyTorch's Philox never draw the same numbers, so the parity tests pass an
object with the same four methods that replays the JAX package's draws
instead.

In a data-parallel rank the draws are the global batch's, as JAX draws
them from a replicated key and lets the batch sharding split them
(``parallel/mesh.py:144-147``): :class:`ShardDraws` draws every random
tensor at the global shape and keeps this rank's rows, and the phase
shifts, host integers from one generator, are the same on every rank. A
P-rank step then takes exactly the draws of the one-process step at the
global batch. Its gradients are averaged over the ranks before each Adam
step (:func:`~.state.apply_updates`), its logs are the global batch's
means, and an evaluation's masked means and real-row count are summed over
the ranks (:mod:`~calciumgan_tpu_torch.ops.signal_metrics`).

A model's random inputs (the calciumgan critic's phase shifts, the mlp
nets' dropout masks) are drawn per pass by the module's ``draw_inputs``;
every step says whether the pass is a training pass (:meth:`GAN.gen`,
:meth:`GAN.dis`), so no module keeps a ``train()``/``eval()`` state. The
vanilla GAN's one forward serves both gradients, so both see the same
masks; evaluation, sampling and generation run without dropout.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from calciumgan_tpu_torch.algorithms.registry import register
from calciumgan_tpu_torch.algorithms.state import (GANState, apply_updates,
                                                   make_net_state)
from calciumgan_tpu_torch.ops import signal_metrics
from calciumgan_tpu_torch.ops.phase_shuffle import draw_shifts
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import tracing


def get_noise(gen: torch.Generator, n: int, noise_dim: int,
              device=None) -> torch.Tensor:
    """``(n, noise_dim)`` standard normal float32, drawn from ``gen`` (which
    must live on ``device``)."""
    return torch.randn((n, noise_dim), generator=gen, device=device,
                       dtype=torch.float32)


class Draws:
    """The random numbers of one step: standard-normal noise, uniform GP
    alpha and dropout keep masks drawn on ``device``, phase shifts on the
    host. ``(seed, counter)``
    seeds both generators, so a resumed run that replays a step's counter
    replays its draws (the JAX package folds ``global_step`` into its run
    key, ``train.py:123``)."""

    def __init__(self, seed: int, counter: int, device):
        state = np.random.SeedSequence([seed, counter]).generate_state(
            2, np.uint64)
        self.device = torch.device(device)
        self._device_gen = torch.Generator(device=self.device).manual_seed(
            int(state[0] >> np.uint64(1)))
        self._host_gen = torch.Generator().manual_seed(
            int(state[1] >> np.uint64(1)))

    def noise(self, n: int, noise_dim: int) -> torch.Tensor:
        return get_noise(self._device_gen, n, noise_dim, self.device)

    def alpha(self, n: int) -> torch.Tensor:
        return torch.rand((n,), generator=self._device_gen,
                          device=self.device, dtype=torch.float32)

    def shifts(self, m: int, count: int):
        return draw_shifts(self._host_gen, m, count)

    def dropout(self, shape, rate: float) -> torch.Tensor:
        """A boolean keep mask, each element kept with ``1 - rate``."""
        return torch.rand(tuple(shape), generator=self._device_gen,
                          device=self.device,
                          dtype=torch.float32) < (1.0 - rate)


class ShardDraws:
    """Rank ``rank``'s share of the global draws of ``draws`` (an object
    with :class:`Draws`' methods) in a run of ``world`` ranks whose local
    batch is ``batch`` rows: each tensor is drawn at its global shape and
    this rank's rows are kept. A pass over ``k`` local batches put end to
    end (the critic's ``concat(real, fake)``) takes rows of each of the
    ``k`` global blocks, as JAX's global mask indexes the global
    concatenation. Phase shifts are host integers, the same on every
    rank."""

    def __init__(self, draws, rank: int, world: int, batch: int):
        self.draws, self.rank, self.world = draws, rank, world
        self.batch = batch

    def _rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        parts = max(1, n // self.batch)
        per = n // parts
        x = x.reshape((parts, self.world, per) + tuple(x.shape[1:]))
        return x[:, self.rank].reshape((n,) + tuple(x.shape[3:]))

    def noise(self, n: int, noise_dim: int) -> torch.Tensor:
        return self._rows(self.draws.noise(n * self.world, noise_dim), n)

    def alpha(self, n: int) -> torch.Tensor:
        return self._rows(self.draws.alpha(n * self.world), n)

    def shifts(self, m: int, count: int):
        return self.draws.shifts(m, count)

    def dropout(self, shape, rate: float) -> torch.Tensor:
        n = shape[0]
        keep = self.draws.dropout((n * self.world,) + tuple(shape[1:]), rate)
        return self._rows(keep, n)


def shard_draws(draws, rank: int, world: int, batch: int):
    """``draws`` itself in a run of one rank, else its :class:`ShardDraws`."""
    return draws if world == 1 else ShardDraws(draws, rank, world, batch)


def eval_gen_variables(state: Mapping) -> dict:
    """Generator variables for generation, as ``GAN.generate`` takes them
    (``gan.py:229-231``): the EMA params when the state has one, else the
    raw ones, beside the generator's BatchNorm running statistics
    (``{}`` without BatchNorm). ``state`` is a train-state dictionary as the
    JAX checkpoints store it (``{"generator": {"params": ..., "batch_stats":
    ...}, "ema_params": ... or None, ...}``)."""
    ema = state.get("ema_params")
    return {"params": ema if ema is not None else state["generator"]["params"],
            "batch_stats": state["generator"].get("batch_stats") or {}}


def denormalize(config, x):
    """Undo min-max normalisation of the generator's output; identity for
    unnormalised data."""
    if not config.normalize:
        return x
    lo, hi = config.signals_min, config.signals_max
    # the span in the JAX package's precision: a Python float for global
    # min/max, a float32 array for per-channel fft norm
    span = hi - lo
    if isinstance(x, torch.Tensor) and isinstance(span, np.ndarray):
        span = torch.as_tensor(span, device=x.device)
        lo = torch.as_tensor(lo, device=x.device)
    return x * span + lo


def generate(generator: torch.nn.Module, noise: torch.Tensor) -> torch.Tensor:
    """Generator output for ``noise`` without autograd (normalised; see
    :func:`calciumgan_tpu_torch.data.pipeline.reverse_preprocessing`): an
    evaluation pass, so a generator with dropout gets no masks."""
    with torch.no_grad():
        return generator(noise)


def bce_with_logits(logits: torch.Tensor, label: int,
                    mask=None) -> torch.Tensor:
    """Keras ``BinaryCrossentropy(from_logits=True)`` against a constant
    label: ``softplus(-x)`` or ``softplus(x)`` as ``logaddexp(., 0)``, exact
    for large logits as ``jax.nn.softplus`` is."""
    logits = logits.float()
    per = torch.logaddexp(-logits if label == 1 else logits,
                          torch.zeros_like(logits))
    return signal_metrics.batch_weighted_mean(per, mask)


def _real_rows(real: torch.Tensor, mask) -> torch.Tensor:
    """This batch's real-row count over the data axis (the epoch mean's
    weight)."""
    if mask is None:
        mask = torch.ones(real.shape[0], device=real.device)
    return mesh_lib.all_reduce_sum(mask.float().sum())


def _eval_mask(real: torch.Tensor, mask):
    """``mask``, or all rows real in a data-parallel rank (whose means must
    be summed over the ranks), or None."""
    if mask is None and mesh_lib.data_group() is not None:
        return torch.ones(real.shape[0], device=real.device)
    return mask


def global_logs(logs: dict) -> dict:
    """A train step's logs as the global batch's means: each rank's means
    of equal local batches (and equal frames of them), averaged over the
    ranks (one all-reduce)."""
    if mesh_lib.data_group() is None:
        return logs
    keys = list(logs)
    mean, = mesh_lib.world_mean([torch.stack(
        [logs[k].float() for k in keys])])
    return dict(zip(keys, mean.unbind()))


@register("gan")
class GAN:
    """Holds the config and the two modules; the steps update a
    :class:`~.state.GANState` made by :meth:`init_state`."""

    has_gradient_penalty = False

    def __init__(self, config, generator, discriminator):
        self.config = config
        self.generator = generator
        self.discriminator = discriminator
        self.noise_dim = int(config.noise_dim)
        self.learning_rate = float(config.learning_rate)
        self.betas = (float(config.adam_beta1), float(config.adam_beta2))
        self.ema = float(getattr(config, "ema", 0.0) or 0.0)
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(f"--ema must be in [0, 1), got {self.ema}")

    def init_state(self) -> GANState:
        ema = ({n: p.detach().clone()
                for n, p in self.generator.named_parameters()}
               if self.ema > 0 else None)
        return GANState(
            make_net_state(self.generator, self.learning_rate, self.betas),
            make_net_state(self.discriminator, self.learning_rate,
                           self.betas), ema)

    # ------------------------------------------------------------------
    def update_ema(self, state: GANState) -> None:
        """``ema = decay * ema + (1 - decay) * params`` after a generator
        step (no-op without an EMA), as the span ``step/ema``."""
        with tracing.span("step/ema"):
            if state.ema is None:
                return
            params = dict(self.generator.named_parameters())
            ema = list(state.ema.values())
            torch._foreach_mul_(ema, self.ema)
            torch._foreach_add_(ema, [params[n].detach() for n in state.ema],
                                alpha=1.0 - self.ema)

    def sample(self, state: GANState, noise: torch.Tensor) -> torch.Tensor:
        """Generator output for evaluation and sampling (no dropout, the
        BatchNorm's running statistics): the EMA params when the state has
        them, else the raw ones. ``functional_call`` swaps in the EMA's
        parameters only, so the module's buffers, the running statistics,
        stay."""
        with torch.no_grad():
            if state.ema is None:
                return self.generator(noise)
            return functional_call(self.generator, state.ema, (noise,))

    def metrics(self, real, fake, mask=None) -> dict:
        return signal_metrics.all_signal_metrics(
            denormalize(self.config, real), denormalize(self.config, fake),
            mask)

    def gen(self, noise: torch.Tensor, draws, *,
            training: bool) -> torch.Tensor:
        """One generator pass with this pass's draws (dropout masks in a
        training pass of a model that has dropout); a training pass of a
        BatchNorm generator moves its running statistics, under
        ``torch.no_grad()`` too."""
        g = self.generator
        return g(noise, *g.draw_inputs(draws, noise.shape[0], training))

    def dis(self, x: torch.Tensor, draws, *, training: bool) -> torch.Tensor:
        """One discriminator pass with this pass's draws (phase shifts;
        dropout masks in a training pass)."""
        d = self.discriminator
        return d(x, *d.draw_inputs(draws, x.shape[0], training))

    # ---- losses -------------------------------------------------------
    def generator_loss(self, fake_output, mask=None):
        return bce_with_logits(fake_output, 1, mask)

    def discriminator_loss(self, real_output, fake_output, mask=None):
        return (bce_with_logits(real_output, 1, mask) +
                bce_with_logits(fake_output, 0, mask))

    # ---- steps --------------------------------------------------------
    def train_step(self, state: GANState, real: torch.Tensor,
                   draws) -> dict:
        B = real.shape[0]
        fake = self.gen(draws.noise(B, self.noise_dim), draws, training=True)
        out = self.dis(torch.cat([real, fake.to(real.dtype)]), draws,
                       training=True)
        gen_loss = self.generator_loss(out[B:])
        dis_loss = self.discriminator_loss(out[:B], out[B:])
        g_grads = torch.autograd.grad(
            gen_loss, list(self.generator.parameters()), retain_graph=True)
        d_grads = torch.autograd.grad(
            dis_loss, list(self.discriminator.parameters()))
        apply_updates(state.generator, g_grads)
        apply_updates(state.discriminator, d_grads)
        self.update_ema(state)
        logs = {"loss/generator": gen_loss.detach(),
                "loss/discriminator": dis_loss.detach()}
        logs.update(self.metrics(real, fake.detach()))
        return global_logs(logs)

    def eval_step(self, state: GANState, real: torch.Tensor, draws,
                  mask: Optional[torch.Tensor] = None):
        """``mask`` (B,) zero-weights padded tail-batch rows so every logged
        mean reduces exactly over the real rows (None = all rows real).
        Returns ``(fake, logs)``."""
        B = real.shape[0]
        mask = _eval_mask(real, mask)
        fake = self.sample(state, draws.noise(B, self.noise_dim))
        with torch.no_grad():
            out = self.dis(torch.cat([real, fake.to(real.dtype)]), draws,
                           training=False)
            logs = {"loss/generator": self.generator_loss(out[B:], mask),
                    "loss/discriminator": self.discriminator_loss(
                        out[:B], out[B:], mask)}
            logs.update(self.metrics(real, fake, mask))
        logs["batch/real_rows"] = _real_rows(real, mask)
        return fake, logs
