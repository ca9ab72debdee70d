"""Plain PyTorch reference of one WGAN-GP training step of the 2-D model
(:mod:`h100bench.reference.model2d`) over signals ``(B, T, N, C)``: the
step of :mod:`h100bench.reference.wgan_gp`, with its Adam, its ``cast``
and ``rows``, the penalty's ``alpha`` broadcast over the three signal axes
and each critic pass's phase shifts drawn as :func:`model2d.draw_shifts`
draws them (time then neuron, layer by layer)."""

from __future__ import annotations

import torch

from h100bench.reference import model, model2d
from h100bench.reference.wgan_gp import Adam, _grads, _mean


def train_step(gen: dict, dis: dict, opt_g: Adam, opt_d: Adam, real,
               draws, cfg, cast=model.identity_cast, rows=None) -> dict:
    """One step in place; returns the step's three losses as floats."""
    B = real.shape[0]
    rows = B if rows is None else rows
    nd = cfg["noise_dim"]
    g_params, d_params = model.nest(gen), model.nest(dis)

    def critic(x):
        return model2d.critic(d_params, x, model2d.draw_shifts(draws, cfg),
                              cfg, cast)

    dis_losses, gps = [], []
    for _ in range(cfg["n_critic"]):
        with torch.no_grad():
            fake = model2d.generator(g_params, draws.noise(B, nd), cfg, cast)
        out = critic(torch.cat([real, fake]))
        alpha = draws.alpha(B).reshape(B, 1, 1, 1)
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
    fake = model2d.generator(g_params, draws.noise(B, nd), cfg, cast)
    gen_loss = -_mean(critic(fake), rows)
    opt_g.update(gen, _grads(gen_loss, gen))
    return {"loss/generator": float(gen_loss.detach()),
            "loss/discriminator": sum(dis_losses) / len(dis_losses),
            "loss/gradient_penalty": sum(gps) / len(gps)}
