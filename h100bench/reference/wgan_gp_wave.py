"""Plain PyTorch reference of one WGAN-GP training step of WaveGAN
(:mod:`h100bench.reference.wavegan`): the step of
:mod:`h100bench.reference.wgan_gp`, with its ``cast`` and ``rows``, on the
paper's Adam (betas 0.5 and 0.9 in its recipe, given by the configuration;
epsilon 1e-7 outside the square root, bias-corrected, as the program's)."""

from __future__ import annotations

import torch

from h100bench.reference import model, wavegan
from h100bench.reference.wgan_gp import ADAM_EPS, _grads, _mean
from h100bench.reference.wgan_gp import Adam as _Adam


class Adam(_Adam):
    """:class:`wgan_gp.Adam` at ``betas``. With ``keep`` it keeps the
    gradients of its first update, ``first``: ``{flax path: float64
    array}``."""

    def __init__(self, params: dict, lr: float, betas: tuple,
                 keep: bool = False):
        super().__init__(params, lr)
        self.betas, self.keep, self.first = betas, keep, None

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        if self.keep and self.first is None:
            self.first = {k: g.detach().double().cpu().numpy()
                          for k, g in grads.items()}
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr * (self.m[k] / c1)
                   / ((self.v[k] / c2).sqrt() + ADAM_EPS))


def train_step(gen: dict, dis: dict, opt_g: Adam, opt_d: Adam, real,
               draws, cfg, cast=model.identity_cast, rows=None) -> dict:
    """One step in place; returns the step's three losses as floats."""
    B = real.shape[0]
    rows = B if rows is None else rows
    nd, ns = cfg["noise_dim"], model.num_shifts(cfg)
    g_params, d_params = model.nest(gen), model.nest(dis)

    def critic(x):
        return wavegan.critic(d_params, x, draws.shifts(cfg["m"], ns), cfg,
                              cast)

    dis_losses, gps = [], []
    for _ in range(cfg["n_critic"]):
        with torch.no_grad():
            fake = wavegan.generator(g_params, draws.noise(B, nd), cfg, cast)
        out = critic(torch.cat([real, fake]))
        alpha = draws.alpha(B).reshape(B, 1, 1)
        x_hat = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
        grad, = torch.autograd.grad(critic(x_hat).sum(), x_hat,
                                    create_graph=True)
        norm = torch.sqrt(grad.reshape(B, -1).square().sum(1) + 1e-12)
        gp = _mean((norm - 1.0).square(), rows)
        loss = (-_mean(out[:B], rows) + _mean(out[B:], rows)
                + cfg["gradient_penalty"] * gp)
        opt_d.update(dis, _grads(loss, dis))
        dis_losses.append(float(loss.detach()))
        gps.append(float(gp.detach()))
    fake = wavegan.generator(g_params, draws.noise(B, nd), cfg, cast)
    gen_loss = -_mean(critic(fake), rows)
    opt_g.update(gen, _grads(gen_loss, gen))
    return {"loss/generator": float(gen_loss.detach()),
            "loss/discriminator": sum(dis_losses) / len(dis_losses),
            "loss/gradient_penalty": sum(gps) / len(gps)}
