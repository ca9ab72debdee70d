"""Model zoo (PyTorch counterpart of :mod:`calciumgan_tpu.models`).

Importing this package registers the ported models: ``calciumgan`` and
``mlp`` (each a generator and a discriminator).
"""

from calciumgan_tpu_torch.models import calciumgan, mlp  # noqa: F401
from calciumgan_tpu_torch.models.registry import (  # noqa: F401
    get_models, models)
