"""The work of the 2-D model's training step, counted from its shapes as
:mod:`h100bench.work` counts the 1-D model's: two FLOPs a multiply-add of
the convolutions and dense layers at the reference's shapes, normalisations
and activations left out, a backward pass twice its forward. A transposed
convolution's work is its products without the zeros of its dilated input
(input positions x kh x kw x Cin x Cout); :func:`generator_products`
counts them with the zeros, as the program's stride-1 convolution over the
dilated input multiplies them. Nothing here is read from the program's
run."""

from __future__ import annotations

from h100bench.reference import model, model2d


def _transpose_layers(cfg):
    """``(input positions, Cin, Cout, sh * sw)`` of each transposed
    convolution, for one sample."""
    h, w = model.noise_width(cfg), cfg["num_neurons"] // 2
    c_in = cfg["noise_dim"]
    for i, f in enumerate(model2d.generator_filters(cfg)):
        sh, sw = model2d.generator_strides(cfg, i)
        yield h * w, c_in, f, sh * sw
        h, w, c_in = h * sh, w * sw, f


def generator_products(cfg: dict, batch: int) -> tuple:
    """``(products, work products)`` of the generator's transposed
    convolutions in one forward at ``batch``: with the dilation's zeros and
    without them."""
    area = cfg["kernel_size"] ** 2
    products = work = 0
    for positions, c_in, c_out, zeros in _transpose_layers(cfg):
        n = batch * positions * area * c_in * c_out
        products, work = products + n * zeros, work + n
    return products, work


def generator_flops(cfg: dict, batch: int) -> float:
    nd, C = cfg["noise_dim"], cfg["num_channels"]
    seed = model.noise_width(cfg) * (cfg["num_neurons"] // 2) * nd
    frames = cfg["sequence_length"] * cfg["num_neurons"]
    return float(2 * batch * nd * seed + 2 * generator_products(cfg, batch)[1]
                 + 2 * batch * frames * C * C)


def critic_flops(cfg: dict, batch: int) -> float:
    (kh, kw), (sh, sw) = model2d.CRITIC_KERNEL, model2d.CRITIC_STRIDES
    c_in, h, w = cfg["num_channels"], cfg["sequence_length"], \
        cfg["num_neurons"]
    flops = 0
    for i in range(5):
        f = cfg["num_units"] * (i + 1)
        h, w = -(-h // sh), -(-w // sw)
        flops += 2 * batch * h * w * kh * kw * c_in * f
        c_in = f
    return float(flops + 2 * batch * h * w * c_in)


def train_step_flops(cfg: dict, batch: int) -> float:
    """One WGAN-GP step at ``batch``, by :func:`h100bench.work.
    train_step_flops`'s count of passes."""
    G, D = generator_flops(cfg, batch), critic_flops(cfg, batch)
    return cfg["n_critic"] * (G + 6 * D + 4 * D) + 3 * G + 2 * D
