"""The control: the reference put in the program's place a precision
below the configuration's (fp8 products for bf16, float32 OASIS for
float64) comes out not correct under each cell's limits. Its readings at
the cells' own sizes on the chip (``h100bench.calibrate``) are in
``PERF.md``; here it runs at a size a CPU test holds."""

from __future__ import annotations

import pytest
import torch

from h100bench import compare, registry
from h100bench.loops import generate, train
from h100bench.reference import model

from conftest import SEED, tiny_cell


@pytest.mark.parametrize("name", ["sl2048-train"])
def test_training_control_fails(name):
    cell = tiny_cell(name, num_units=8, kernel_size=8)
    cfg, mix = cell["config_data"], cell["traffic_data"]
    ref = train.reference_readings(cfg, mix, SEED, "cpu")
    fp8 = train.reference_readings(cfg, mix, SEED, "cpu",
                                   cast=model.fp8_cast)
    correct, _ = compare.judge(compare.training_numbers(fp8, ref),
                               registry.limits(name))
    assert not correct


@pytest.mark.parametrize("name", ["sl2048-generate", "sl16384-generate"])
def test_serving_control_fails(name):
    cell = tiny_cell(name, num_units=8, kernel_size=8)
    cfg = cell["config_data"]
    gen_w = generate.served_weights(cfg, "cpu")
    z = torch.randn((4, cfg["noise_dim"]),
                    generator=torch.Generator().manual_seed(1))
    ref = generate.reference_signals(cfg, gen_w, z)
    fp8 = generate.reference_signals(cfg, gen_w, z, model.fp8_cast)
    truth = generate.reference_spikes(cfg, fp8)
    f32 = generate.reference_spikes(cfg, fp8, torch.float32)
    numbers = compare.generate_numbers(fp8.numpy(), ref.numpy(),
                                       f32.numpy(), truth.numpy())
    correct, _ = compare.judge(numbers, registry.limits(name))
    assert not correct
