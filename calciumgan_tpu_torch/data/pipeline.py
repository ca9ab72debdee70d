"""Reverse preprocessing (counterpart of
``calciumgan_tpu/data/pipeline.py:236-251``, reference ``utils.py:49-63``).

The loading half of the JAX pipeline comes with the training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from calciumgan_tpu_torch.algorithms.gan import denormalize


def ifft_signals(signals: np.ndarray) -> np.ndarray:
    """Inverse FFT of ``(N, W, C)`` spectra, real part only: a copy of
    ``ifft_signals`` in ``calciumgan_tpu/data/segments.py``. The channel
    axis holds the real halves then the imaginary halves. Generated spectra
    are not conjugate-symmetric, so this stays a full complex ifft with the
    imaginary residue dropped; the transform axis is made contiguous
    first."""
    mid = signals.shape[-1] // 2
    spec = np.ascontiguousarray(np.moveaxis(
        signals[..., :mid] + 1j * signals[..., mid:], 1, 2).astype(
            np.complex64))
    out = np.fft.ifft(spec, axis=-1).real
    return np.ascontiguousarray(np.moveaxis(out, 2, 1)).astype(np.float32)


def reverse_preprocessing(config, x: torch.Tensor) -> torch.Tensor:
    """Generator output -> signals in recording units, NWC, on ``x``'s
    device: denormalise, undo the conv2d channel layout, inverse FFT (on the
    host, through :func:`ifft_signals`)."""
    x = denormalize(config, x)
    if config.conv2d:
        if config.fft:
            x = torch.cat((x[..., 0], x[..., 1]), dim=-1)
        else:
            x = x.squeeze(-1)
    if config.fft:
        x = torch.from_numpy(ifft_signals(x.cpu().numpy())).to(x.device)
    return x
