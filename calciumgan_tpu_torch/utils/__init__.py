"""Utilities (counterpart of :mod:`calciumgan_tpu.utils`): checkpoints
(the port's own and the JAX importer), the h5 writer of the serving CLI,
the TensorBoard event writer, training summaries and the trace figure."""
