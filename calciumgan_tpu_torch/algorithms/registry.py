"""Algorithm registry (counterpart of
``calciumgan_tpu/algorithms/registry.py``)."""

from __future__ import annotations

from calciumgan_tpu_torch.models.registry import Registry

algorithms: Registry = Registry("algorithm")
register = algorithms.register


def get_algorithm(config, generator, discriminator):
    """Instantiate the configured algorithm over (generator,
    discriminator)."""
    return algorithms.get(config.algorithm)(config, generator, discriminator)
