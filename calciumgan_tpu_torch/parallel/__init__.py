"""Multi-GPU parallelism (counterpart of :mod:`calciumgan_tpu.parallel`).

The data axis is ported: one rank per GPU, each holding its share of the
global batch, with all-reduced gradients and BatchNorm statistics of the
global batch (:mod:`.mesh`), started on one host or joined from
``torchrun`` (:mod:`.launch`). Model parallelism and
the time axis (``halo_conv``, ``seq_parallel``, ``long_context``) are not
ported yet: ``--model_parallelism`` and ``--time_parallelism`` above 1
raise.
"""

