"""Train-time signal fidelity metrics (copy of
``calciumgan_tpu/ops/signal_metrics.py:19-88`` in torch).

Squared errors between real and fake of the per-position min, max, mean and
standard deviation, each reduced over the LAST axis (the neuron axis of NWC
signals, as the reference's ``signals_metrics.py:9-28``), averaged over
positions with optional per-row weights. The standard deviation is the
population one (``correction=0``), as ``jnp.std`` computes it.

In a parallel rank a masked mean is the global batch's, as JAX computes it
over the sharded batch: the weighted sum and the weight are summed over
every rank first (:func:`~calciumgan_tpu_torch.parallel.mesh.metric_sum`:
a time rank holds its frames of each row, model peers the same values). An
unmasked mean stays the rank's own (a train step's loss, whose gradient
the step all-reduces instead).
"""

from __future__ import annotations

from typing import Optional

import torch

from calciumgan_tpu_torch.parallel import mesh as mesh_lib


def batch_weighted_mean(x: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of ``x`` with optional per-row (dim 0) weights: a ``(B,)`` mask
    makes padded validation rows weightless, so tail batches reduce exactly
    over their real rows; over every rank's rows (and frames) in a
    parallel run."""
    if mask is None:
        return x.mean()
    w = mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1)).float()
    per_row = x.numel() // x.shape[0]
    total, weight = mesh_lib.metric_sum(
        torch.stack([(x.float() * w).sum(), w.sum()]))
    return total / (weight * per_row)


def min_signals_error(real, fake, mask=None):
    return batch_weighted_mean(
        (real.amin(-1) - fake.amin(-1)).square(), mask)


def max_signals_error(real, fake, mask=None):
    return batch_weighted_mean(
        (real.amax(-1) - fake.amax(-1)).square(), mask)


def mean_signals_error(real, fake, mask=None):
    return batch_weighted_mean(
        (real.mean(-1) - fake.mean(-1)).square(), mask)


def std_signals_error(real, fake, mask=None):
    return batch_weighted_mean(
        (real.std(-1, correction=0) - fake.std(-1, correction=0)).square(),
        mask)


def all_signal_metrics(real, fake, mask=None) -> dict:
    """The metric dict logged per step (reference ``gan.py:32-41``)."""
    return {
        "signals_metrics/min": min_signals_error(real, fake, mask),
        "signals_metrics/max": max_signals_error(real, fake, mask),
        "signals_metrics/mean": mean_signals_error(real, fake, mask),
        "signals_metrics/std": std_signals_error(real, fake, mask),
    }
