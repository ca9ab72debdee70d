"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (no fallback to the host)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu "
                           "to run on the host)")
    return device
