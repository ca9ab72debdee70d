"""Utilities (counterpart of :mod:`calciumgan_tpu.utils`); the JAX-free
:mod:`calciumgan_tpu.utils.h5` is reused, not copied."""
