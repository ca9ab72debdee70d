"""Model zoo (PyTorch counterpart of :mod:`calciumgan_tpu.models`).

Importing this package registers the ported models: ``calciumgan``
(generator and discriminator).
"""

from calciumgan_tpu_torch.models import calciumgan  # noqa: F401
from calciumgan_tpu_torch.models.registry import (  # noqa: F401
    get_models, models)
