"""Each traffic mix's loop at a tiny size on the CPU, in float32, against
the reference: the program's steps and served batches agree with it to
float32 rounding, and the run's line reads correct under the cell's
limits."""

from __future__ import annotations

import pytest

from h100bench import run

from conftest import run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["sl2048-train", "sl2048-generate",
                                  "sl16384-generate"])
def test_one_chip_loops_match_the_reference(name):
    cell = tiny_cell(name)
    result = run_tiny(cell)
    for value in result["numbers"].values():
        assert value <= 1e-4
    assert run.result_line(cell, result, False)["correct"] is True


def test_data_parallel_loop_matches_the_reference():
    """The training loop on two gloo ranks, as a data-parallel cell runs
    it: each rank's readings are held to the one-process reference at the
    global batch."""
    cell = tiny_cell("sl2048-train", chips=2)
    result = run_tiny(cell)
    assert result["count"] == 2
    assert result["numbers"]["grad_gap"] <= 1e-4
    assert result["numbers"]["change_gap"] <= 1e-4
    assert result["context"]["bytes_per_step"] > 0
