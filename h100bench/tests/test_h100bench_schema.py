"""The last line's schema, and the refusal without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from h100bench import registry, run

from conftest import run_tiny, tiny_cell


@pytest.fixture(scope="module")
def train_result():
    return tiny_cell("sl2048-train"), run_tiny(tiny_cell("sl2048-train"))


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(train_result, traced):
    cell, result = train_result
    line = run.result_line(cell, result, traced)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(line)
    names = set(line["metrics"])
    if traced:
        assert names == {"train_mfu_pct"}  # the CPU traces no device
    else:
        assert names == {"train_samples_per_s", "train_step_p90_ms",
                         "setup_s"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}


def test_every_cell_reports_setup_and_another_metric():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in registry.metrics_for("end_to_end",
                                                       w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_for("per_layer", w["name"])
        assert (registry.ROOT / "h100bench" / "traffic"
                / f"{w['traffic']}.json").exists()


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", "sl2048-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=registry.ROOT, capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout == ""
