"""Model registry (counterpart of ``calciumgan_tpu/models/registry.py``).

Reuses the JAX package's JAX-free :class:`calciumgan_tpu.registry.Registry`
and keeps its ``wavegan`` alias. Only the generator half is ported so far:
a builder returns the generator module; the discriminator joins with the
training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from calciumgan_tpu.registry import Registry

models: Registry = Registry("model")
register = models.register


def get_models(config, rng: Optional[torch.Generator] = None,
               device=None):
    """Instantiate the generator for ``config.model`` on ``device``. Its
    initial weights are glorot-uniform draws from ``rng`` (default: a CPU
    generator seeded with ``config.seed``)."""
    name = config.model
    if name == "wavegan" and name not in models:
        name = "calciumgan"
    if rng is None:
        rng = torch.Generator().manual_seed(int(config.seed))
    return models.get(name)(config, rng=rng, device=device)
