"""Data helpers (counterpart of :mod:`calciumgan_tpu.data`): reverse
preprocessing of generated signals."""
