"""A configuration, a traffic mix and a per-layer metric added as files
and entries alone, in a copy of the harness, are found by name and run."""

from __future__ import annotations

import json
import shutil
import time

import pytest

from h100bench import registry, run
from h100bench.loops import generate

from conftest import SEED, TINY_MODEL


@pytest.fixture
def copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.ROOT / "h100bench", root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", root)
    h = root / "h100bench"
    cfg = json.loads((h / "configs" / "calciumgan-sl2048.json").read_text())
    cfg.update(TINY_MODEL, name="calciumgan-tiny")
    (h / "configs" / "calciumgan-tiny.json").write_text(json.dumps(cfg))
    (h / "traffic" / "generate_tiny.json").write_text(json.dumps(dict(
        loop="generate", batch_size=4, with_spikes=True, warm_batches=1,
        traced_batches=1, kept_rows_per_batch=1, checked_rows=2)))
    (h / "metrics" / "batches_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['batches'])\n")
    (h / "limits" / "tiny-generate.json").write_text(json.dumps(
        {"limits": {"signal_rms_gap": 1e-4, "spike_mismatches": 0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "calciumgan-tiny", "source": "x",
                             "file": "h100bench/configs/calciumgan-tiny.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny-generate",
                               "config": "calciumgan-tiny",
                               "traffic": "generate_tiny", "chips": 1,
                               "why": "x"})
    rate, = [m for m in bench["end_to_end"]
             if m["name"] == "gen_samples_per_s"]
    rate["workloads"].append("tiny-generate")
    bench["per_layer"].append({"name": "batches_seen", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving core",
                               "moves": "gen_samples_per_s",
                               "workloads": ["tiny-generate"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_added_files_are_found_and_run(copy):
    cell = registry.cell("tiny-generate", copy)
    assert cell["config_data"]["sequence_length"] == 128
    assert cell["traffic_data"]["batch_size"] == 4
    result = generate.run(cell, SEED, 0.0, True, time.time(), device="cpu")
    line = run.result_line(cell, result, True, copy)
    assert line["metrics"]["batches_seen"] == {"value": 2.0,
                                               "unit": "batches"}
    assert line["correct"] is True
    line = run.result_line(cell, result, False, copy)
    assert set(line["metrics"]) == {"gen_samples_per_s", "setup_s"}


def test_metric_reader_by_name(copy):
    assert registry.reader("batches_seen", copy)({"batches": 3}) == 3.0


def test_unknown_workload_names_the_known(copy):
    with pytest.raises(KeyError, match="tiny-generate"):
        registry.cell("no-such-cell", copy)


def test_a_metric_of_cells_shares_its_quantity_reader(copy):
    """``<quantity>.<cells>`` reads with ``metrics/<quantity>.py`` unless a
    file of its own name is there."""
    ctx = {"traces": [{"busy_s": 1.0, "window_s": 4.0}]}
    assert registry.reader("device_idle_pct.gen", copy)(ctx) == 75.0
    assert registry.reader("batches_seen.tiny", copy)({"batches": 3}) == 3.0
    (copy / "h100bench" / "metrics" / "batches_seen.tiny.py").write_text(
        "def read(ctx):\n    return -1.0\n")
    assert registry.reader("batches_seen.tiny", copy)({"batches": 3}) == -1.0
