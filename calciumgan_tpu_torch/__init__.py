"""CalciumGAN in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of the JAX package :mod:`calciumgan_tpu`, which stays the reference
it is tested against. The modules mirror the JAX package's layout so that
each one's counterpart is easy to find. The port imports ``torch`` and never
``jax``, ``flax`` or ``optax``; from the JAX package it reuses only the
modules that are free of JAX at import time (``config``, ``registry``,
``ops.oasis_ref``, ``native``, ``data.segments``, ``utils.h5``), and
callers of the port reach them through it: :mod:`.config` and
:mod:`.ops.golden`.

Slice ported so far: serving (``python -m calciumgan_tpu_torch.generate``):
restore a JAX checkpoint, run the generator, and deconvolve the generated
traces with the hand-written OASIS AR(1) CUDA kernel
(``csrc/oasis_ar1.cu``).
"""
