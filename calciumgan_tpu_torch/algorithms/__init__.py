"""GAN algorithms (counterpart of :mod:`calciumgan_tpu.algorithms`).

Importing this package registers ``gan`` and ``wgan-gp``."""

from calciumgan_tpu_torch.algorithms import gan, wgan_gp  # noqa: F401
from calciumgan_tpu_torch.algorithms.registry import (  # noqa: F401
    algorithms, get_algorithm)
