"""Plain PyTorch reference of WaveGAN's generator and critic, written from
the paper (Donahue, McAuley and Puckette, "Adversarial Audio Synthesis",
ICLR 2019, arXiv:1802.04208, Tables 1-3), on weights in Flax's layout as
:mod:`h100bench.reference.model` takes them: Dense kernels ``(in, out)``,
Conv and ConvTranspose kernels ``(K, Cin, Cout)``, named ``Dense_0`` and
``ConvTranspose_0..4`` in the generator, ``Conv_0..4`` and ``Dense_0`` in
the critic.

Model size ``d`` (``num_units``), ``K`` taps at stride ``s``, latent
``noise_dim``, ``c`` channels, ``T`` frames, ``w0 = T / s**5``:
- generator: Dense to ``w0 x 16d``, reshaped ``(w0, 16d)``, ReLU; five
  transposed convolutions to 8d, 4d, 2d, d and c channels, ReLU after
  each, tanh after the last;
- critic: five convolutions to d, 2d, 4d, 8d and 16d channels, LeakyReLU
  0.2 after each, phase shuffle after the first four; flatten
  (time-major, as the paper's reshape of ``(w0, 16d)``) and Dense to 1.

Float32 throughout, with TF32 off (the caller sets the switches); every
product goes through ``cast`` (:func:`model.fp8_cast` for the control).
The convolutions are :mod:`h100bench.reference.model`'s: SAME padding with
the floor half on the left, and the transposed convolution as XLA defines
it (the input dilated by the stride, padded and correlated at stride 1).
No kernel of the program, no JAX.

Departures from the paper, each also the program's:
- the transposed convolutions are lax's SAME (the dilated input padded
  (14, 13) at K 25, s 4, the kernel not flipped), not TensorFlow's
  ``conv2d_transpose``, the gradient of a SAME convolution: the same
  frames, each kernel's taps in reverse order;
- the noise is N(0, 1), as the program draws it, not U(-1, 1);
- ``c`` is 102, one channel a neuron, not audio's one;
- the program computes in bfloat16 (the configuration's precision);
- no post-processing filter on the generator's output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference import model
from h100bench.reference.model import identity_cast

SLOPE = 0.2  # the critic's LeakyReLU


def _filters(cfg, ks) -> list:
    return [cfg["num_units"] * k for k in ks]


def generator(params, z, cfg, cast=identity_cast):
    """Noise ``(B, noise_dim)`` -> signals ``(B, T, c)`` in [-1, 1]."""
    w0, c0 = model.noise_width(cfg), 16 * cfg["num_units"]
    x = model.dense(z, params["Dense_0"], cast)
    x = torch.relu(x.reshape(z.shape[0], w0, c0).transpose(1, 2))
    for i in range(5):
        x = model.conv_transpose_same(x, params[f"ConvTranspose_{i}"],
                                      cfg["strides"], cast)
        x = torch.tanh(x) if i == 4 else torch.relu(x)
    return x.transpose(1, 2)


def critic(params, x, shifts, cfg, cast=identity_cast):
    """Signals ``(B, T, c)`` and the four phase shifts -> ``(B, 1)``."""
    x = x.transpose(1, 2)
    for i in range(5):
        x = F.leaky_relu(model.conv_same(x, params[f"Conv_{i}"],
                                         cfg["strides"], cast), SLOPE)
        if i < len(shifts):
            x = model.phase_shuffle(x, shifts[i], cfg["m"])
    x = x.transpose(1, 2).reshape(x.shape[0], -1)
    return model.dense(x, params["Dense_0"], cast)


def generator_shapes(cfg) -> dict:
    """Each generator leaf's shape, by its Flax path ``group/leaf``."""
    nd, K = cfg["noise_dim"], cfg["kernel_size"]
    c_in = 16 * cfg["num_units"]
    shapes = {"Dense_0/kernel": (nd, model.noise_width(cfg) * c_in),
              "Dense_0/bias": (model.noise_width(cfg) * c_in,)}
    for i, f in enumerate(_filters(cfg, (8, 4, 2, 1))
                          + [cfg["num_channels"]]):
        shapes[f"ConvTranspose_{i}/kernel"] = (K, c_in, f)
        shapes[f"ConvTranspose_{i}/bias"] = (f,)
        c_in = f
    return shapes


def critic_shapes(cfg) -> dict:
    K = cfg["kernel_size"]
    shapes = {}
    c_in, width = cfg["num_channels"], cfg["sequence_length"]
    for i, f in enumerate(_filters(cfg, (1, 2, 4, 8, 16))):
        shapes[f"Conv_{i}/kernel"] = (K, c_in, f)
        shapes[f"Conv_{i}/bias"] = (f,)
        c_in, width = f, -(-width // cfg["strides"])
    shapes["Dense_0/kernel"] = (width * c_in, 1)
    shapes["Dense_0/bias"] = (1,)
    return shapes
