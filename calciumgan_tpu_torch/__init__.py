"""CalciumGAN in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of the JAX package :mod:`calciumgan_tpu`, which stays the reference
it is tested against. The modules mirror the JAX package's layout so that
each one's counterpart is easy to find. The port imports ``torch`` and
nothing of the JAX package, not even its JAX-free modules: it keeps its own
copies of what it needs (:mod:`.config`, the registry in
:mod:`.models.registry`, ``ifft_signals`` in :mod:`.data.pipeline`, the
float64 golden in :mod:`.ops.golden`, the h5 writer in :mod:`.utils.h5`,
the TFRecord codec in :mod:`.data.tfrecord`, the event writer in
:mod:`.utils.tb`, the signal metrics, the phase shuffle, the DG model's
host helpers in :mod:`.ops.dg`, and the C++
float64 redo ``csrc/oasis_host.cc`` and crc32c ``csrc/crc32c.cc``), each
saying which module it mirrors.

Slices ported so far: serving (``python -m calciumgan_tpu_torch.generate``),
whole-recording spike inference (``python -m
calciumgan_tpu_torch.dataset.spike_train_inference``), training
(``python -m calciumgan_tpu_torch.main``), dataset preparation and
evaluation (``...dataset.generate_tfrecords``, ``...compute_metrics``), each
deconvolving on the hand-written OASIS AR(1) CUDA kernel
(``csrc/oasis_ar1.cu``), and the DG experiments (``...dataset.
generate_dg_data``, ``...dataset.generate_surrogate_data``, the ``mlp``
model, ``...compute_dg_metrics``), the conv2d model and BatchNorm, the
sweep (``python -m calciumgan_tpu_torch.search``), the figure render pool
and the in-graph ``ops.oasis.deconvolve_signals``.
"""
