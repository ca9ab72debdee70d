"""Model registry (counterpart of ``calciumgan_tpu/models/registry.py``).

:class:`Registry` is a copy of the JAX package's name-to-factory registry
(``calciumgan_tpu/registry.py``). The ``wavegan`` alias is kept. A model's
build function returns ``(generator, discriminator)``, as the JAX
package's do.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Optional, TypeVar

import torch

T = TypeVar("T")


class Registry(Generic[T]):

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def wrapper(obj: T) -> T:
            if name in self._entries:
                raise KeyError(f"duplicate {self.kind} name {name!r}")
            self._entries[name] = obj
            return obj
        return wrapper

    def get(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{sorted(self._entries)}")
        return self._entries[name]

    def names(self):
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


models: Registry = Registry("model")
register = models.register


def get_models(config, rng: Optional[torch.Generator] = None,
               device=None):
    """Instantiate ``(generator, discriminator)`` for ``config.model`` on
    ``device``. Their initial weights are glorot-uniform draws from ``rng``
    (default: a CPU generator seeded with ``config.seed``), the generator's
    first."""
    name = config.model
    if name == "wavegan" and name not in models:
        name = "calciumgan"
    if rng is None:
        rng = torch.Generator().manual_seed(int(config.seed))
    return models.get(name)(config, rng=rng, device=device)
