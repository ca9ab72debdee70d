"""Spike deconvolution for evaluation and serving (counterpart of
``calciumgan_tpu/eval/spike_eval.py:28-50``).

The spike statistics and the epoch-file drivers come with a later slice.
"""

from __future__ import annotations

import numpy as np

from calciumgan_tpu_torch.ops.oasis import deconvolve_signals_host


def deconvolve_traces(traces) -> np.ndarray:
    """Binary spikes (host ``np.int8``) of ``(..., T)`` traces, a tensor on
    the CPU or the GPU or a numpy array. The OASIS kernel runs where the
    traces lie: the CUDA kernel on the GPU, its plain PyTorch version on the
    CPU; flagged traces are recomputed in float64 on the host
    (:func:`calciumgan_tpu_torch.ops.oasis.deconvolve_signals_host`)."""
    return deconvolve_signals_host(traces)
