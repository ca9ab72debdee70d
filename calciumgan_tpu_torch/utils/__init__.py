"""Utilities (counterpart of :mod:`calciumgan_tpu.utils`): checkpoints
(the port's own and the JAX importer), the h5 writer of the serving CLI,
the TensorBoard event writer (with the sweep's HParams events), training
and metrics summaries with their figure render pool, and the figures."""
