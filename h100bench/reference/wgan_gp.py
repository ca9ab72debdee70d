"""Plain PyTorch reference of one WGAN-GP training step with Adam, written
from the JAX package's ``calciumgan_tpu/algorithms/wgan_gp.py`` and
``state.py`` (commit 8a6615f):

- ``n_critic`` critic updates on the same real batch, each with fresh
  noise: one critic pass over ``concat(real, fake)`` with one draw of
  phase shifts, the gradient penalty with per-row ``alpha ~ U(0, 1)`` and
  its own shifts, ``norm = sqrt(sum(grad^2) + 1e-12)`` per row, the
  penalty's gradient taken through the input gradient (double backward);
- then one generator update against the updated critic, with a third draw
  of shifts;
- Adam with betas (0.9, 0.999) and epsilon 1e-7 outside the square root,
  bias-corrected, no weight decay.

Parameters are a flat ``{flax path: tensor}`` per net. The draws come from
the object the harness hands both sides (``noise``, ``alpha``, ``shifts``).
``rows`` < the batch takes every mean over the first ``rows`` rows only:
the fault "half of the batch left out".
"""

from __future__ import annotations

import torch

from h100bench.reference import model

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-7


class Adam:

    def __init__(self, params: dict, lr: float):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - BETA1 ** self.t, 1.0 - BETA2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
            self.v[k].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
            p.sub_(self.lr * (self.m[k] / c1)
                   / ((self.v[k] / c2).sqrt() + ADAM_EPS))


def _mean(x, rows):
    return x.float()[:rows].mean()


def _grads(loss, params: dict) -> dict:
    keys = list(params)
    return dict(zip(keys, torch.autograd.grad(loss, [params[k]
                                                     for k in keys])))


def train_step(gen: dict, dis: dict, opt_g: Adam, opt_d: Adam, real,
               draws, cfg, cast=model.identity_cast, rows=None) -> dict:
    """One step in place; returns the step's three losses as floats."""
    B = real.shape[0]
    rows = B if rows is None else rows
    nd, ns = cfg["noise_dim"], model.num_shifts(cfg)
    g_params, d_params = model.nest(gen), model.nest(dis)
    dis_losses, gps = [], []
    for _ in range(cfg["n_critic"]):
        with torch.no_grad():
            fake = model.generator(g_params, draws.noise(B, nd), cfg, cast)
        out = model.critic(d_params, torch.cat([real, fake]),
                           draws.shifts(cfg["m"], ns), cfg, cast)
        alpha = draws.alpha(B).reshape(B, 1, 1)
        x_hat = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
        o = model.critic(d_params, x_hat, draws.shifts(cfg["m"], ns), cfg,
                         cast)
        grad, = torch.autograd.grad(o.sum(), x_hat, create_graph=True)
        norm = torch.sqrt(grad.reshape(B, -1).square().sum(1) + 1e-12)
        gp = _mean((norm - 1.0).square(), rows)
        loss = (-_mean(out[:B], rows) + _mean(out[B:], rows)
                + cfg["gradient_penalty"] * gp)
        opt_d.update(dis, _grads(loss, dis))
        dis_losses.append(float(loss.detach()))
        gps.append(float(gp.detach()))
    fake = model.generator(g_params, draws.noise(B, nd), cfg, cast)
    gen_loss = -_mean(model.critic(d_params, fake,
                                   draws.shifts(cfg["m"], ns), cfg, cast),
                      rows)
    opt_g.update(gen, _grads(gen_loss, gen))
    return {"loss/generator": float(gen_loss.detach()),
            "loss/discriminator": sum(dis_losses) / len(dis_losses),
            "loss/gradient_penalty": sum(gps) / len(gps)}
