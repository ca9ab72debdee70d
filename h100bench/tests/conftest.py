"""Shared pieces of the harness's CPU tests. Tests that need an NVIDIA GPU
take the ``card`` fixture, which skips them without one (decided when the
test runs, never at import)."""

from __future__ import annotations

import time

import pytest

from h100bench import registry

TINY_MODEL = dict(sequence_length=128, num_neurons=4, num_channels=4,
                  noise_dim=8, num_units=4, kernel_size=4, m=2,
                  mixed_precision=False)
TINY_MIX = {"train": dict(batch_size=8, rows=32, checked_steps=3,
                          warm_steps=1, traced_steps=2),
            "generate": dict(batch_size=8, warm_batches=1,
                             traced_batches=1, checked_rows=4)}
SEED = 2 ** 33 + 12345  # past 32 bits, as the driver's seeds are


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def tiny_cell(name: str, chips: int = 1, **model) -> dict:
    """Cell ``name`` at a size the CPU runs in seconds, in float32."""
    cell = registry.cell(name)
    cfg = dict(cell["config_data"], **TINY_MODEL)
    cfg.update(model)
    mix = dict(cell["traffic_data"])
    mix.update(TINY_MIX[mix["loop"]])
    if mix["loop"] == "train":
        mix["data_parallelism"] = chips
    return dict(cell, config_data=cfg, traffic_data=mix, chips=chips)


def run_tiny(cell: dict, fault=None, seconds: float = 0.0) -> dict:
    import importlib
    loop = importlib.import_module(
        f"h100bench.loops.{cell['traffic_data']['loop']}")
    extra = {} if fault is None else {"fault": fault}
    return loop.run(cell, SEED, seconds, False, time.time(), device="cpu",
                    **extra)
