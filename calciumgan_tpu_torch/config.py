"""Typed configuration of the port: the JAX package's
:class:`calciumgan_tpu.config.Config`, reused rather than copied.

``calciumgan_tpu/config.py`` imports JAX only inside ``Config.save()``,
which the port never calls, so importing it here loads no JAX. Callers of
the port take ``Config`` from this module.
"""

from calciumgan_tpu.config import Config

__all__ = ["Config"]
