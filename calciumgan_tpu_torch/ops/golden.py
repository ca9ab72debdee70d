"""The float64 reference the port's OASIS is held to: the JAX package's
numpy golden model, ``calciumgan_tpu/ops/oasis_ref.py``, reused rather than
copied (it imports only numpy).

It shares no code with the CUDA kernel, its plain PyTorch twin or the C++
float64 redo of :mod:`calciumgan_tpu_torch.ops.oasis`, so agreement with it
is an independent check. It is about 100x slower than the C++ redo: a
reference for checks, not a path of the dispatch.
"""

from __future__ import annotations

import numpy as np

from calciumgan_tpu.ops import oasis_ref
from calciumgan_tpu.ops.oasis_ref import synth_ar1_traces

__all__ = ["golden_spikes", "synth_ar1_traces"]


def golden_spikes(traces: np.ndarray, g: float = 0.95, s_min: float = 0.55,
                  threshold: float = 0.5) -> np.ndarray:
    """Binary float64 OASIS spikes of ``(N, T)`` host traces as ``np.int8``."""
    return oasis_ref.deconvolve_signals_ref(
        np.asarray(traces, np.float64), g=g, s_min=s_min,
        threshold=threshold).astype(np.int8)
