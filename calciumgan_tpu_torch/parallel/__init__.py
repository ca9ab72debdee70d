"""Multi-GPU parallelism (counterpart of :mod:`calciumgan_tpu.parallel`).

One rank per GPU, started on one host or joined from ``torchrun``
(:mod:`.launch`), laid out on a ``(data, model)`` or ``(data, time)`` mesh
with a process group per axis (:mod:`.mesh`):

- data parallelism: each rank holds its share of the global batch, with
  all-reduced gradients and BatchNorm statistics of the global batch;
- model parallelism: the two sequence-sized Dense layers (the critic's
  flatten head and the generator's input projection) sharded over the
  model axis (:func:`.mesh.shard_models`);
- time (sequence, context) parallelism: every sequence's frames split
  over the time axis, with halo exchanges between neighbours
  (:mod:`.halo_conv`, :mod:`.seq_parallel`, :mod:`.long_context`).
"""
