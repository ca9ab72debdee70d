"""Plain PyTorch reference of the CalciumGAN generator and critic, written
from the Flax definitions they follow (``calciumgan_tpu/models/
calciumgan.py`` and ``base.py`` at commit 8a6615f), on weights in Flax's
layout: Dense kernels ``(in, out)``, Conv and ConvTranspose kernels ``(K,
Cin, Cout)``, a ``LayerNorm_0`` group of ``scale`` and ``bias`` under each
``Norm_i``.

Float32 throughout, with TF32 off (the caller sets the switches). Every
convolution and dense product goes through ``cast``, which sees the input
and the weight of each product: the identity for the reference, a rounding
to a lower precision for the control (:func:`fp8_cast`). No kernel, cache or
batching of the program: the transposed convolution is XLA's definition of
it (the input dilated by the stride, padded and correlated at stride 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SLOPE = 0.3            # LeakyReLU, Keras's default
LAYER_NORM_EPS = 1e-3  # Keras's epsilon, which the Flax models keep
FP8_MAX = 448.0        # largest float8_e4m3fn


def identity_cast(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at 448), as an fp8 product takes it; the gradient
    passes straight through the rounding."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


def _leaky(x):
    return F.leaky_relu(x, SLOPE)


def dense(x, leaf, cast):
    return cast(x) @ cast(leaf["kernel"]) + leaf["bias"]


def conv_same(x, leaf, stride, cast):
    """Flax ``Conv(padding="SAME")`` on NCW ``x``: ``ceil(W/s)`` output
    frames, the padding's floor half on the left."""
    kernel = leaf["kernel"]
    K, W = kernel.shape[0], x.shape[-1]
    out = -(-W // stride)
    total = max((out - 1) * stride + K - W, 0)
    x = F.pad(x, (total // 2, total - total // 2))
    y = F.conv1d(cast(x), cast(kernel.permute(2, 1, 0)), stride=stride)
    return y + leaf["bias"][:, None]


def conv_transpose_same(x, leaf, stride, cast):
    """Flax ``ConvTranspose(padding="SAME")`` (``lax.conv_transpose``, the
    kernel not flipped) on NCW ``x``: ``W*s`` output frames."""
    kernel = leaf["kernel"]
    K = kernel.shape[0]
    B, C, W = x.shape
    dilated = x.new_zeros(B, C, (W - 1) * stride + 1)
    dilated[..., ::stride] = x
    pad_len = K + stride - 2
    pad_a = K - 1 if stride > K - 1 else -(-pad_len // 2)
    dilated = F.pad(dilated, (pad_a, pad_len - pad_a))
    y = F.conv1d(cast(dilated), cast(kernel.permute(2, 1, 0)))
    return y + leaf["bias"][:, None]


def layer_norm(x, leaf):
    """LayerNorm over the channels of NCW ``x``."""
    mean = x.mean(1, keepdim=True)
    var = (x - mean).square().mean(1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + LAYER_NORM_EPS)
    return y * leaf["scale"][:, None] + leaf["bias"][:, None]


def phase_shuffle(x, shift: int, m: int):
    """NCW ``x`` moved by ``shift`` frames along time, the edges reflected
    (the edge frame not repeated); ``shift`` and ``m`` clamped to the
    width less one."""
    W = x.shape[-1]
    m = min(m, W - 1)
    shift = max(-m, min(m, int(shift)))
    if shift == 0:
        return x
    idx = torch.arange(W, device=x.device) + shift
    idx = torch.where(idx < 0, -idx, idx)
    idx = torch.where(idx > W - 1, 2 * (W - 1) - idx, idx)
    return x[..., idx]


def noise_width(cfg) -> int:
    w = cfg["sequence_length"] / cfg["strides"] ** 5
    if not float(w).is_integer():
        raise ValueError("sequence_length must divide by strides**5")
    return int(w)


def generator(params, z, cfg, cast=identity_cast):
    """Noise ``(B, noise_dim)`` -> normalised signals ``(B, T, C)``."""
    nd, stride = cfg["noise_dim"], cfg["strides"]
    x = _leaky(dense(z, params["Dense_0"], cast))
    x = x.reshape(z.shape[0], noise_width(cfg), nd).transpose(1, 2)
    for i in range(5):
        x = conv_transpose_same(x, params[f"ConvTranspose_{i}"], stride, cast)
        norm = params.get(f"Norm_{i}", {}).get("LayerNorm_0")
        if cfg["layer_norm"] and x.shape[1] > 1:
            x = layer_norm(x, norm)
        x = _leaky(x)
    x = dense(x.transpose(1, 2), params["Dense_1"], cast)
    return torch.sigmoid(x) if cfg["normalize"] else x


def num_shifts(cfg) -> int:
    return 4 if cfg["m"] > 0 else 0


def critic(params, x, shifts, cfg, cast=identity_cast):
    """Signals ``(B, T, C)`` and the four phase shifts -> ``(B, 1)``."""
    x = x.transpose(1, 2)
    for i in range(5):
        x = _leaky(conv_same(x, params[f"Conv_{i}"], cfg["strides"], cast))
        if i < len(shifts):
            x = phase_shuffle(x, shifts[i], cfg["m"])
    x = x.transpose(1, 2).reshape(x.shape[0], -1)
    return dense(x, params["Dense_0"], cast)


def denormalize(cfg, x):
    if not cfg["normalize"]:
        return x
    return x * (cfg["signals_max"] - cfg["signals_min"]) + cfg["signals_min"]


def generator_shapes(cfg) -> dict:
    """Each generator leaf's shape, by its Flax path ``group/leaf``."""
    nd, u, K, C = (cfg["noise_dim"], cfg["num_units"], cfg["kernel_size"],
                   cfg["num_channels"])
    shapes = {"Dense_0/kernel": (nd, noise_width(cfg) * nd),
              "Dense_0/bias": (noise_width(cfg) * nd,)}
    c_in = nd
    for i, f in enumerate([5 * u, 4 * u, 3 * u, 2 * u, C]):
        shapes[f"ConvTranspose_{i}/kernel"] = (K, c_in, f)
        shapes[f"ConvTranspose_{i}/bias"] = (f,)
        if cfg["layer_norm"] and f > 1:
            shapes[f"Norm_{i}/LayerNorm_0/scale"] = (f,)
            shapes[f"Norm_{i}/LayerNorm_0/bias"] = (f,)
        c_in = f
    shapes["Dense_1/kernel"] = (C, C)
    shapes["Dense_1/bias"] = (C,)
    return shapes


def critic_shapes(cfg) -> dict:
    u, K = cfg["num_units"], cfg["kernel_size"]
    shapes = {}
    c_in, width = cfg["num_channels"], cfg["sequence_length"]
    for i in range(5):
        f = u * (i + 1)
        shapes[f"Conv_{i}/kernel"] = (K, c_in, f)
        shapes[f"Conv_{i}/bias"] = (f,)
        c_in, width = f, -(-width // cfg["strides"])
    shapes["Dense_0/kernel"] = (width * c_in, 1)
    shapes["Dense_0/bias"] = (1,)
    return shapes


def nest(flat: dict) -> dict:
    """``{"a/b/c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    out: dict = {}
    for path, t in flat.items():
        *groups, leaf = path.split("/")
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = t
    return out


def fan(path: str, shape) -> tuple:
    """Glorot's ``(fan_in, fan_out)`` of a kernel: a convolution counts its
    receptive field."""
    if len(shape) == 2:
        return shape[0], shape[1]
    area = math.prod(shape[:-2])
    return area * shape[-2], area * shape[-1]
