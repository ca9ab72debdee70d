"""Inference half of the GAN algorithm (counterpart of
``calciumgan_tpu/algorithms/gan.py:88-108,226-231``).

Noise comes from an explicit ``torch.Generator``: JAX's threefry and
PyTorch's Philox never draw the same numbers, so parity tests hand both
packages the same numpy noise instead. The train and eval steps come with
the training slice.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def get_noise(gen: torch.Generator, n: int, noise_dim: int,
              device=None) -> torch.Tensor:
    """``(n, noise_dim)`` standard normal float32, drawn from ``gen`` (which
    must live on ``device``)."""
    return torch.randn((n, noise_dim), generator=gen, device=device,
                       dtype=torch.float32)


def eval_gen_params(state: Mapping):
    """Generator params for generation: the EMA when the state has one.
    ``state`` is a train-state dictionary as the JAX checkpoints store it
    (``{"generator": {"params": ...}, "ema_params": ... or None, ...}``)."""
    ema = state.get("ema_params")
    return ema if ema is not None else state["generator"]["params"]


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
    :func:`calciumgan_tpu_torch.data.pipeline.reverse_preprocessing`). The
    ported generator has no layer that behaves differently in training, so
    there is no mode to set."""
    with torch.no_grad():
        return generator(noise)
