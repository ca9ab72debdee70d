"""The work of WaveGAN's training step, counted from its shapes as
:mod:`h100bench.work` counts the 1-D CalciumGAN's: two FLOPs a
multiply-add of the convolutions and dense layers at the reference's
shapes (:mod:`h100bench.reference.wavegan`), activations left out, a
transposed convolution's products without the zeros of its dilated input
(input frames x K x Cin x Cout), a backward pass twice its forward.
Nothing here is read from the program's run."""

from __future__ import annotations

from h100bench.reference import model


def generator_flops(cfg: dict, batch: int) -> float:
    u, K = cfg["num_units"], cfg["kernel_size"]
    w, c_in = model.noise_width(cfg), 16 * u
    flops = 2 * batch * cfg["noise_dim"] * w * c_in
    for f in (8 * u, 4 * u, 2 * u, u, cfg["num_channels"]):
        flops += 2 * batch * w * K * c_in * f
        c_in, w = f, w * cfg["strides"]
    return float(flops)


def critic_flops(cfg: dict, batch: int) -> float:
    u, K = cfg["num_units"], cfg["kernel_size"]
    c_in, w = cfg["num_channels"], cfg["sequence_length"]
    flops = 0
    for f in (u, 2 * u, 4 * u, 8 * u, 16 * u):
        w = -(-w // cfg["strides"])
        flops += 2 * batch * w * K * c_in * f
        c_in = f
    return float(flops + 2 * batch * w * c_in)


def train_step_flops(cfg: dict, batch: int) -> float:
    """One WGAN-GP step at ``batch``, by :func:`h100bench.work.
    train_step_flops`'s count of passes."""
    G, D = generator_flops(cfg, batch), critic_flops(cfg, batch)
    return cfg["n_critic"] * (G + 6 * D + 4 * D) + 3 * G + 2 * D
