"""The program's own spans and counters, ``calciumgan_tpu_torch.utils.
tracing``, as per-layer readers take them: this process's host seconds by
span, spans closed and counts, since it started (the loops pass no change
over the window, so every batch of the run counts: warm, measured and
traced). A program without them reads None."""

from __future__ import annotations

import importlib


def counters():
    """``(totals, calls)`` of the program under test, else None."""
    try:
        tracing = importlib.import_module(
            "calciumgan_tpu_torch.utils.tracing")
    except ImportError:
        return None
    return tracing.totals, tracing.calls


def ms_per(names, per: str):
    """Host milliseconds of the spans ``names`` per closed span ``per``."""
    found = counters()
    if found is None or not found[1][per]:
        return None
    totals, calls = found
    return 1e3 * sum(totals[n] for n in names) / calls[per]
