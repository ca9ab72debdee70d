"""Utilities (counterpart of :mod:`calciumgan_tpu.utils`): the JAX
checkpoint importer and the h5 writer of the serving CLI."""
