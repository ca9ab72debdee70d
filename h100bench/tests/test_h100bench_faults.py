"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a cell can have: a step that leaves its state
unchanged, half the batch left out, the exchange between chips left out,
a served signal or spike altered where it is produced; and a rank that
loads a module of the JAX stack refuses the run."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from h100bench import run

from conftest import run_tiny, tiny_cell


def _correct(cell, result) -> bool:
    return run.result_line(cell, result, False)["correct"]


def test_state_unchanged(monkeypatch):
    from calciumgan_tpu_torch.algorithms import wgan_gp
    monkeypatch.setattr(wgan_gp, "apply_updates", lambda net, grads: None)
    cell = tiny_cell("sl2048-train")
    result = run_tiny(cell)
    assert result["numbers"]["change_gap"] == 1.0
    assert not _correct(cell, result)


def test_half_the_batch(monkeypatch):
    from calciumgan_tpu_torch.algorithms import wgan_gp
    step = wgan_gp.WGAN_GP.train_step
    monkeypatch.setattr(wgan_gp.WGAN_GP, "train_step",
                        lambda self, state, real, draws: step(
                            self, state, real[:real.shape[0] // 2], draws))
    cell = tiny_cell("sl2048-train")
    assert not _correct(cell, run_tiny(cell))


def test_exchange_left_out():
    from h100bench.calibrate import no_exchange
    cell = tiny_cell("sl2048-train", chips=2)
    assert not _correct(cell, run_tiny(cell, fault=no_exchange))


def test_signal_altered(monkeypatch):
    from calciumgan_tpu_torch.algorithms import gan
    produce = gan.generate
    monkeypatch.setattr(gan, "generate", lambda g, z: torch.roll(
        produce(g, z), 1, 0))
    cell = tiny_cell("sl2048-generate")
    assert not _correct(cell, run_tiny(cell))


def test_spike_altered(monkeypatch):
    from calciumgan_tpu_torch import generate
    deconvolve = generate.deconvolve_traces

    def flipped(traces):
        spikes = deconvolve(traces)
        spikes[..., spikes.shape[-1] // 2] ^= np.int8(1)
        return spikes

    monkeypatch.setattr(generate, "deconvolve_traces", flipped)
    cell = tiny_cell("sl2048-generate")
    result = run_tiny(cell)
    assert result["numbers"]["spike_mismatches"] > 0
    assert not _correct(cell, result)


def loads_flax(algo) -> None:
    """A rank that loads the JAX package's stack under the program."""
    import sys
    import types
    sys.modules.setdefault("flax", types.ModuleType("flax"))


@pytest.mark.parametrize("fault, code", [(None, 0), (loads_flax, 3)],
                         ids=["sound", "rank_loads_flax"])
def test_forbidden_module_in_a_rank_refuses_the_run(capsys, fault, code):
    """A module of the JAX stack that only a spawned rank loads is seen,
    and the run prints no result."""
    import sys
    cell = tiny_cell("sl2048-train", chips=2)
    result = run_tiny(cell, fault=fault)
    assert "flax" not in sys.modules
    assert run.report(cell, result, False) == code
    out = capsys.readouterr()
    if code:
        assert out.out == ""
        assert "flax" in out.err
    else:
        assert json.loads(out.out.splitlines()[-1])["correct"] is True
