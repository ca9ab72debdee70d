"""Model zoo (PyTorch counterpart of :mod:`calciumgan_tpu.models`).

Importing this package registers the ported models: ``calciumgan``,
``calciumgan2d`` and ``mlp`` (each a generator and a discriminator), and
``wavegan_paper``, WaveGAN at its published layout, which the JAX package
does not have.
"""

from calciumgan_tpu_torch.models import (  # noqa: F401
    calciumgan, calciumgan2d, mlp, wavegan)
from calciumgan_tpu_torch.models.registry import (  # noqa: F401
    get_models, models)
