"""On the card: each one-chip cell's command runs end to end, short, and
prints a correct result as its last line. Run on a machine with an H100:

    python3 -m pytest h100bench/tests/test_h100bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from h100bench import registry


@pytest.mark.card
@pytest.mark.parametrize("name", ["sl2048-train", "sl2048-generate",
                                  "sl16384-generate"])
def test_cell_runs_correct_on_the_card(card, name):
    proc = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", name,
         "--seed", str(2 ** 33 + 7), "--seconds", "3", "--trace", "0"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
def test_reference_oasis_graph_equals_eager(card):
    """The reference's CUDA-graph replay gives the eager loop's spikes."""
    import torch
    from h100bench.reference import oasis
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((256, 3000), generator=gen, dtype=torch.float32)
    on_card = oasis.spikes(x.cuda(), 0.95, 0.55, 0.5).cpu()
    assert torch.equal(on_card, oasis.spikes(x, 0.95, 0.55, 0.5))
