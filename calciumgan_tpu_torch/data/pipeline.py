"""Reverse preprocessing (counterpart of
``calciumgan_tpu/data/pipeline.py:236-251``, reference ``utils.py:49-63``).

The loading half of the JAX pipeline comes with the training slice.
"""

from __future__ import annotations

import torch

from calciumgan_tpu.data import segments as seg
from calciumgan_tpu_torch.algorithms.gan import denormalize


def reverse_preprocessing(config, x: torch.Tensor) -> torch.Tensor:
    """Generator output -> signals in recording units, NWC, on ``x``'s
    device: denormalise, undo the conv2d channel layout, inverse FFT (on the
    host, through :func:`calciumgan_tpu.data.segments.ifft_signals`)."""
    x = denormalize(config, x)
    if config.conv2d:
        if config.fft:
            x = torch.cat((x[..., 0], x[..., 1]), dim=-1)
        else:
            x = x.squeeze(-1)
    if config.fft:
        x = torch.from_numpy(seg.ifft_signals(x.cpu().numpy())).to(x.device)
    return x
