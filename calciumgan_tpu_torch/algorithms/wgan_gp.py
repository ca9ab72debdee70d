"""WGAN-GP: Wasserstein GAN with gradient penalty (counterpart of
``calciumgan_tpu/algorithms/wgan_gp.py``).

The paper's semantics, as the JAX package keeps them:

- the SAME real batch feeds all ``n_critic`` critic steps and the generator
  step, with fresh noise each step (``wgan_gp.py:103-135``);
- each critic step makes one discriminator pass over ``concat(real,
  fake)`` with one shift draw, and the gradient penalty its own pass with
  its own shift draw (``:70``);
- the penalty interpolates with per-sample ``alpha ~ U(0, 1)`` against the
  detached fake and takes ``dD(x_hat)/dx_hat`` of the float32 sum with
  ``create_graph=True``, so the critic's gradient differentiates through it;
  the norm is per sample, float32, with ``+1e-12`` inside the square root
  (``:68-84``);
- the generator step runs the UPDATED critic with a third shift draw and
  differentiates w.r.t. the generator's parameters only (``:141-155``);
- a model with dropout (``mlp``) draws fresh masks for every pass of a
  train step: the generator's, the critic's over ``concat(real, fake)``,
  the penalty's (dropout is active inside the penalty, ``:74-77``) and the
  generator step's two; ``eval_step`` runs every pass without dropout;
- a ``--batch_norm`` generator moves its running statistics in each of
  its ``n_critic + 1`` training passes: the critic steps' (under
  ``torch.no_grad()``) and the generator step's (``:107-154``).

``--unroll_critic`` (XLA cost accounting) and the sharding pins (a
partitioner workaround) have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from calciumgan_tpu_torch.algorithms.gan import (GAN, _eval_mask, _real_rows,
                                                 global_logs)
from calciumgan_tpu_torch.algorithms.registry import register
from calciumgan_tpu_torch.algorithms.state import GANState, apply_updates
from calciumgan_tpu_torch.ops import signal_metrics
from calciumgan_tpu_torch.utils import tracing


@register("wgan-gp")
class WGAN_GP(GAN):

    has_gradient_penalty = True

    def __init__(self, config, generator, discriminator):
        super().__init__(config, generator, discriminator)
        self.penalty = float(config.gradient_penalty)
        self.n_critic = int(config.n_critic)
        if self.n_critic < 1:
            raise ValueError(f"n_critic must be >= 1, got {self.n_critic}")

    def sequence_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a per-sample sum over this process's frames, summed over
        the whole sequence: itself here, where every frame is this
        process's (a time-parallel run sums over its time group)."""
        return x

    # ---- losses -------------------------------------------------------
    def generator_loss(self, fake_output, mask=None):
        return -signal_metrics.batch_weighted_mean(fake_output.float(), mask)

    def wasserstein_dis_loss(self, real_output, fake_output, mask=None):
        return (-signal_metrics.batch_weighted_mean(real_output.float(), mask)
                + signal_metrics.batch_weighted_mean(fake_output.float(),
                                                     mask))

    def gradient_penalty(self, draws, real, fake, mask=None,
                         create_graph: bool = True, *,
                         training: bool) -> torch.Tensor:
        B = real.shape[0]
        alpha = draws.alpha(B).reshape((B,) + (1,) * (real.ndim - 1))
        with torch.enable_grad():
            x_hat = (alpha * real + (1.0 - alpha) *
                     fake.detach().to(real.dtype)).requires_grad_(True)
            out = self.dis(x_hat, draws, training=training)
            grad, = torch.autograd.grad(out.float().sum(), x_hat,
                                        create_graph=create_graph)
        norm = torch.sqrt(self.sequence_sum(
            grad.float().reshape(B, -1).square().sum(1)) + 1e-12)
        return signal_metrics.batch_weighted_mean((norm - 1.0).square(), mask)

    # ---- steps --------------------------------------------------------
    def train_step(self, state: GANState, real: torch.Tensor,
                   draws) -> dict:
        """One step as the span ``step`` over ``step/critic`` (each critic
        iteration but its update; ``step/penalty`` inside it),
        ``step/generator``, the updates' ``step/update``, ``step/ema`` and
        ``step/metrics`` (:mod:`~calciumgan_tpu_torch.utils.tracing`)."""
        with tracing.span("step", step=state.generator.step):
            B = real.shape[0]
            d_params = list(self.discriminator.parameters())
            dis_losses, gps = [], []
            for _ in range(self.n_critic):
                with tracing.span("step/critic"):
                    with torch.no_grad():
                        fake = self.gen(draws.noise(B, self.noise_dim),
                                        draws, training=True)
                    out = self.dis(torch.cat([real, fake.to(real.dtype)]),
                                   draws, training=True)
                    with tracing.span("step/penalty"):
                        gp = self.gradient_penalty(draws, real, fake,
                                                   training=True)
                    loss = self.wasserstein_dis_loss(out[:B], out[B:]) \
                        + self.penalty * gp
                    grads = torch.autograd.grad(loss, d_params)
                apply_updates(state.discriminator, grads)
                dis_losses.append(loss.detach())
                gps.append(gp.detach())

            with tracing.span("step/generator"):
                fake = self.gen(draws.noise(B, self.noise_dim), draws,
                                training=True)
                gen_loss = self.generator_loss(self.dis(fake, draws,
                                                        training=True))
                grads = torch.autograd.grad(
                    gen_loss, list(self.generator.parameters()))
            apply_updates(state.generator, grads)
            self.update_ema(state)

            with tracing.span("step/metrics"):
                logs = {"loss/generator": gen_loss.detach(),
                        "loss/discriminator": torch.stack(dis_losses).mean(),
                        "loss/gradient_penalty": torch.stack(gps).mean()}
                logs.update(self.metrics(real, fake.detach()))
                return global_logs(logs)

    def eval_step(self, state: GANState, real: torch.Tensor, draws,
                  mask: Optional[torch.Tensor] = None):
        """``mask`` (B,) zero-weights padded tail-batch rows so every logged
        mean reduces exactly over the real rows (None = all rows real).
        Returns ``(fake, logs)``."""
        mask = _eval_mask(real, mask)
        fake = self.sample(state, draws.noise(real.shape[0], self.noise_dim))
        with torch.no_grad():
            real_out = self.dis(real, draws, training=False)
            fake_out = self.dis(fake, draws, training=False)
        gp = self.gradient_penalty(draws, real, fake, mask,
                                   create_graph=False, training=False)
        with torch.no_grad():
            logs = {
                "loss/generator": self.generator_loss(fake_out, mask),
                "loss/discriminator":
                    self.wasserstein_dis_loss(real_out, fake_out, mask)
                    + self.penalty * gp,
                "loss/gradient_penalty": gp.detach(),
            }
            logs.update(self.metrics(real, fake, mask))
        logs["batch/real_rows"] = _real_rows(real, mask)
        return fake, logs
