"""The per-layer readers of the program's own spans and counters
(:mod:`h100bench.spans`): their values on the program's counters, None
without them, and all four in the traced line of a serving run."""

from __future__ import annotations

import collections
import sys
import time

import pytest

from h100bench import registry, run
from h100bench.loops import generate

from conftest import SEED, tiny_cell

READERS = ("gen_to_host_ms_per_batch", "gen_layout_ms_per_batch",
           "oasis_redo_ms_per_batch", "oasis_flagged_pct")


@pytest.fixture
def program(monkeypatch):
    """Counters of four served batches in the program's tracing module."""
    from calciumgan_tpu_torch.utils import tracing
    totals = collections.Counter({
        "generate/batch": 4.0, "generate/signals_to_host": 1.2,
        "oasis/spikes_to_host": 0.4, "generate/layout": 0.8,
        "oasis/redo": 1.0, "oasis/traces": 400, "oasis/flagged": 30})
    monkeypatch.setattr(tracing, "totals", totals)
    monkeypatch.setattr(tracing, "calls",
                        collections.Counter({"generate/batch": 4}))
    return totals


@pytest.mark.parametrize("name, value", [
    ("gen_to_host_ms_per_batch", 400.0), ("gen_layout_ms_per_batch", 200.0),
    ("oasis_redo_ms_per_batch", 250.0), ("oasis_flagged_pct", 7.5)])
def test_reader_value(program, name, value):
    assert registry.reader(name)({}) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_program_counters(monkeypatch, name):
    """The parent's program has no tracing module."""
    monkeypatch.setitem(sys.modules, "calciumgan_tpu_torch.utils.tracing",
                        None)
    assert registry.reader(name)({"batches": 3}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_before_any_batch(monkeypatch, name):
    from calciumgan_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "totals", collections.Counter())
    monkeypatch.setattr(tracing, "calls", collections.Counter())
    assert registry.reader(name)({}) is None


def test_a_traced_serving_run_reports_them():
    cell = tiny_cell("sl2048-generate")
    result = generate.run(cell, SEED, 0.0, True, time.time(), device="cpu")
    line = run.result_line(cell, result, True)
    for name in READERS:
        assert line["metrics"][name]["value"] >= 0.0, name
    assert line["metrics"]["oasis_flagged_pct"]["unit"] == "%"
