"""Plain PyTorch reference of the 2-D CalciumGAN generator and critic, which
treat (time, neuron) as an image plane, written from the Flax definitions
they follow (``calciumgan_tpu/models/calciumgan2d.py`` and ``base.py`` at
commit 3ff964e; the model of ``gan/models/calciumgan2d.py`` in
github.com/bryanlimy/CalciumGAN), on weights in Flax's layout: Dense
kernels ``(in, out)``, Conv and ConvTranspose kernels ``(kh, kw, Cin,
Cout)``, a ``LayerNorm_0`` group of ``scale`` and ``bias`` under each
``Norm_i``.

- Generator: noise -> Dense to ``w0 x N/2 x noise_dim`` -> LeakyReLU ->
  (time, neuron, channel) -> five transposed convolutions of ``(k, k)``
  with filters ``5u, 3u, 2u, u, C`` at strides ``(s, 1)``, ``(s, 2)`` at
  layer 2, each followed by LayerNorm over the channels and LeakyReLU ->
  Dense(C) -> sigmoid for normalised data. The LayerNorm is skipped where
  the channels are one (the last layer): the JAX package and the port
  skip it there, the TF original does not, and its norm of a single
  element returns its bias, a constant that cuts the generator's output off
  its noise (``BASELINE.md``, "conv2d regression").
- Critic: five ``(16, 16)`` convolutions at stride ``(4, 1)`` with filters
  ``u, 2u, .., 5u``, each followed by LeakyReLU, the first four by a 2-D
  phase shuffle: time by up to ``m`` on layers 0-2 and by 0 on layer 3
  (the original's quirk), neurons by up to ``n`` -> the (time, neuron,
  channel) flatten -> Dense(1).

Shapes are ``(B, T, N, C)`` at the boundary and NCHW inside. Float32
throughout, TF32 off (the caller sets the switches); every convolution and
dense product goes through ``cast`` as in :mod:`h100bench.reference.model`.
SAME padding is XLA's on each axis, the floor half on the left; the
transposed convolution is XLA's definition of it: the input dilated by the
strides, padded and correlated at stride 1 with the unflipped kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference import model

CRITIC_KERNEL, CRITIC_STRIDES = (16, 16), (4, 1)
SHUFFLED = 4  # critic layers followed by a phase shuffle


def _leaky(x):
    return F.leaky_relu(x, model.SLOPE)


def _torch_kernel(kernel):
    """Flax ``(kh, kw, Cin, Cout)`` -> ``F.conv2d``'s ``(Cout, Cin, kh,
    kw)``, not flipped: both are correlations."""
    return kernel.permute(3, 2, 0, 1)


def _pad(x, pads):
    """``x`` padded by ``(lo, hi)`` on its time and neuron axes."""
    (t_lo, t_hi), (n_lo, n_hi) = pads
    return F.pad(x, (n_lo, n_hi, t_lo, t_hi))


def same_pads(width: int, kernel: int, stride: int) -> tuple:
    """XLA's SAME padding of one axis: ``ceil(W/s)`` outputs, the floor
    half of the total on the left."""
    out = -(-width // stride)
    total = max((out - 1) * stride + kernel - width, 0)
    return total // 2, total - total // 2


def transpose_pads(kernel: int, stride: int) -> tuple:
    """``lax.conv_transpose``'s SAME padding of one dilated axis: ``K+s-2``
    in all, ``K-1`` before if ``s > K-1``, else the ceiling half."""
    total = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return before, total - before


def conv_same(x, leaf, strides, cast):
    """Flax ``Conv(padding="SAME")`` on NCHW ``x``."""
    kernel = leaf["kernel"]
    pads = [same_pads(w, k, s) for w, k, s in
            zip(x.shape[2:], kernel.shape[:2], strides)]
    y = F.conv2d(cast(_pad(x, pads)), cast(_torch_kernel(kernel)),
                 stride=strides)
    return y + leaf["bias"][:, None, None]


def conv_transpose_same(x, leaf, strides, cast):
    """Flax ``ConvTranspose(padding="SAME")`` on NCHW ``x``: ``H*sh`` by
    ``W*sw`` outputs."""
    kernel = leaf["kernel"]
    B, C, H, W = x.shape
    sh, sw = strides
    dilated = x.new_zeros(B, C, (H - 1) * sh + 1, (W - 1) * sw + 1)
    dilated[..., ::sh, ::sw] = x
    pads = [transpose_pads(k, s) for k, s in zip(kernel.shape[:2], strides)]
    y = F.conv2d(cast(_pad(dilated, pads)), cast(_torch_kernel(kernel)))
    return y + leaf["bias"][:, None, None]


def layer_norm(x, leaf):
    """LayerNorm over the channels of NCHW ``x``."""
    mean = x.mean(1, keepdim=True)
    var = (x - mean).square().mean(1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + model.LAYER_NORM_EPS)
    return y * leaf["scale"][:, None, None] + leaf["bias"][:, None, None]


def _shift(x, shift: int, m: int, dim: int):
    """``x`` moved by ``shift`` along ``dim``, the edges reflected (the edge
    not repeated); ``shift`` and ``m`` clamped to the width less one."""
    W = x.shape[dim]
    m = min(m, W - 1)
    shift = max(-m, min(m, int(shift)))
    if shift == 0:
        return x
    idx = torch.arange(W, device=x.device) + shift
    idx = torch.where(idx < 0, -idx, idx)
    idx = torch.where(idx > W - 1, 2 * (W - 1) - idx, idx)
    return x.index_select(dim, idx)


def phase_shuffle_2d(x, shifts, m: int, n: int):
    """NCHW ``x`` moved along time by ``shifts[0]`` where ``m > 0``, then
    along neurons by ``shifts[1]`` where ``n > 0``."""
    if m > 0:
        x = _shift(x, shifts[0], m, 2)
    if n > 0:
        x = _shift(x, shifts[1], n, 3)
    return x


def generator_filters(cfg) -> list:
    u = cfg["num_units"]
    return [5 * u, 3 * u, 2 * u, u, cfg["num_channels"]]


def generator_strides(cfg, layer: int) -> tuple:
    return cfg["strides"], 2 if layer == 2 else 1


def time_bounds(cfg) -> tuple:
    """The time shift's bound at each shuffled critic layer."""
    return (cfg["m"],) * (SHUFFLED - 1) + (0,)


def draw_shifts(draws, cfg) -> list:
    """One ``(time, neuron)`` pair a shuffled layer, drawn time then neuron,
    layer by layer, one ``draws.shifts(bound, 1)`` each; an axis whose bound
    is 0 draws nothing and takes 0."""
    out = []
    for m in time_bounds(cfg):
        pair = [draws.shifts(bound, 1 if bound > 0 else 0)
                for bound in (m, cfg["n"])]
        out.append(tuple(d[0] if d else 0 for d in pair))
    return out


def generator(params, z, cfg, cast=model.identity_cast):
    """Noise ``(B, noise_dim)`` -> normalised signals ``(B, T, N, C)``."""
    nd = cfg["noise_dim"]
    x = _leaky(model.dense(z, params["Dense_0"], cast))
    x = x.reshape(z.shape[0], model.noise_width(cfg),
                  cfg["num_neurons"] // 2, nd).permute(0, 3, 1, 2)
    for i in range(len(generator_filters(cfg))):
        x = conv_transpose_same(x, params[f"ConvTranspose_{i}"],
                                generator_strides(cfg, i), cast)
        if cfg["layer_norm"] and x.shape[1] > 1:
            x = layer_norm(x, params[f"Norm_{i}"]["LayerNorm_0"])
        x = _leaky(x)
    x = model.dense(x.permute(0, 2, 3, 1), params["Dense_1"], cast)
    return torch.sigmoid(x) if cfg["normalize"] else x


def critic(params, x, shifts, cfg, cast=model.identity_cast):
    """Signals ``(B, T, N, C)`` and the four ``(time, neuron)`` shifts ->
    ``(B, 1)``."""
    x = x.permute(0, 3, 1, 2)
    for i in range(5):
        x = _leaky(conv_same(x, params[f"Conv_{i}"], CRITIC_STRIDES, cast))
        if i < SHUFFLED:
            x = phase_shuffle_2d(x, shifts[i], time_bounds(cfg)[i],
                                 cfg["n"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return model.dense(x, params["Dense_0"], cast)


def generator_shapes(cfg) -> dict:
    """Each generator leaf's shape, by its Flax path ``group/leaf``."""
    nd, K, C = cfg["noise_dim"], cfg["kernel_size"], cfg["num_channels"]
    seed = model.noise_width(cfg) * (cfg["num_neurons"] // 2) * nd
    shapes = {"Dense_0/kernel": (nd, seed), "Dense_0/bias": (seed,)}
    c_in = nd
    for i, f in enumerate(generator_filters(cfg)):
        shapes[f"ConvTranspose_{i}/kernel"] = (K, K, c_in, f)
        shapes[f"ConvTranspose_{i}/bias"] = (f,)
        if cfg["layer_norm"] and f > 1:
            shapes[f"Norm_{i}/LayerNorm_0/scale"] = (f,)
            shapes[f"Norm_{i}/LayerNorm_0/bias"] = (f,)
        c_in = f
    shapes["Dense_1/kernel"] = (C, C)
    shapes["Dense_1/bias"] = (C,)
    return shapes


def critic_shapes(cfg) -> dict:
    u = cfg["num_units"]
    shapes = {}
    c_in, frames = cfg["num_channels"], cfg["sequence_length"]
    for i in range(5):
        f = u * (i + 1)
        shapes[f"Conv_{i}/kernel"] = (*CRITIC_KERNEL, c_in, f)
        shapes[f"Conv_{i}/bias"] = (f,)
        c_in, frames = f, -(-frames // CRITIC_STRIDES[0])
    shapes["Dense_0/kernel"] = (frames * cfg["num_neurons"] * c_in, 1)
    shapes["Dense_0/bias"] = (1,)
    return shapes
