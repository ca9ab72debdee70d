"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``limits/<cell>.json``, set from the readings ``PERF.md``
gives).

Training (the first three steps, readings of both sides keyed alike):

- ``loss_gap``: the widest gap of a step's logged loss (generator, critic,
  gradient penalty) from the reference's, over that loss's largest
  reference value in the three steps;
- ``grad_gap``: by the worst leaf, the gap between the norms of Adam's
  first moment after step 1 (a tenth of the generator's gradient; the
  critic's five gradients, weighted as Adam weighs them) on the two sides;
- ``change_gap``: by the worst leaf, the gap between the norms of each
  parameter's change over the three steps.

A leaf's gap is over the larger of its reference norm and its net's median
leaf's. A leaf whose reference first moment is under a thousandth of its
net's median leaf's (the critic's output bias, whose gradient cancels) is
left out of both: Adam moves it by round-off alone.

Serving (the rows sampled after the window):

- ``signal_rms_gap``: the root mean square of the served signals' gap from
  the reference's, over the reference's standard deviation;
- ``spike_mismatches``: served spikes that differ from the float64
  reference's on the served signals (an exact comparison).
"""

from __future__ import annotations

import math
import statistics

import numpy as np

LOSSES = ("loss/generator", "loss/discriminator", "loss/gradient_penalty")
NETS = ("generator", "discriminator")
SILENT_LEAF = 1e-3


def _net_median(norms: dict, net: str) -> float:
    return statistics.median(v for k, v in norms.items()
                             if k.startswith(net + "/"))


def moving_leaves(ref_grad: dict) -> list:
    """The leaves held to the reference: all but those whose reference
    first moment is under SILENT_LEAF of their net's median leaf's."""
    keep = []
    for net in NETS:
        med = _net_median(ref_grad, net)
        keep += [k for k, v in ref_grad.items()
                 if k.startswith(net + "/") and v >= SILENT_LEAF * med]
    return keep


def _worst_leaf(prog: dict, ref: dict, leaves) -> float:
    worst = 0.0
    for net in NETS:
        med = _net_median(ref, net)
        for k in leaves:
            if k.startswith(net + "/"):
                scale = max(ref[k], med)
                worst = max(worst, abs(prog[k] - ref[k]) / scale)
    return worst


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"losses": [per step {name: value}], "grad":
    {net/path: norm}, "change": {net/path: norm}}``."""
    loss_gap = 0.0
    for name in LOSSES:
        scale = max(abs(step[name]) for step in ref["losses"])
        for p, r in zip(prog["losses"], ref["losses"]):
            gap = abs(p[name] - r[name]) / scale
            loss_gap = max(loss_gap, gap if math.isfinite(gap) else math.inf)
    leaves = moving_leaves(ref["grad"])
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(prog["grad"], ref["grad"], leaves),
            "change_gap": _worst_leaf(prog["change"], ref["change"], leaves)}


def generate_numbers(signals, ref_signals, spikes, ref_spikes) -> dict:
    """Host arrays of the sampled rows, served and reference."""
    gap = np.asarray(signals, np.float64) - np.asarray(ref_signals,
                                                       np.float64)
    spread = float(np.std(np.asarray(ref_signals, np.float64)))
    return {"signal_rms_gap": float(np.sqrt(np.mean(gap * gap))) / spread,
            "spike_mismatches": int(np.count_nonzero(
                np.asarray(spikes, bool) != np.asarray(ref_spikes, bool)))}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})`` for each number the cell's
    limits name: each at most its limit. A cell without limits, or a named
    number missing or not finite, is not correct. A number the limits do
    not name is read but not compared (``PERF.md`` says why)."""
    checks, correct = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        correct = correct and value == value and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return correct, checks
