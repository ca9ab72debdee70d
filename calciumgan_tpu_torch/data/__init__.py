"""Data helpers (counterpart of :mod:`calciumgan_tpu.data`); the JAX-free
:mod:`calciumgan_tpu.data.segments` is reused, not copied."""
