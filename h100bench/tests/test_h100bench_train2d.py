"""The 2-D training cell ``conv2d-train`` at a tiny size on the CPU, in
float32: its loop against the 2-D reference, the faults and the control
its limits refuse (a state left unchanged, half the batch, fp8 products),
the critic's first-gradient gap by hand, its files and readers found by
name, each new reader on a synthetic context and without its input, and
its work count by hand.

The tiny cell runs at learning rate 1e-5: Adam's first step, ``lr * g /
(|g| + 1e-7)``, is steep where ``|g|`` is near 1e-7, and at the recipe's
1e-4 the critic's output biases, whose gradients cancel between real and
fake rows, take the float32 rounding of their gradients up to 4e-4 of the
run's gaps (measured), past the 1e-4 that the loops are held to here."""

from __future__ import annotations

import collections
import math
import sys
import time

import numpy as np
import pytest

from h100bench import compare, registry, run, work2d
from h100bench.loops import train2d
from h100bench.reference import model

from conftest import SEED

CELL = "conv2d-train"
TINY_2D = dict(sequence_length=64, num_neurons=8, noise_dim=4, num_units=4,
               kernel_size=4, m=2, mixed_precision=False, learning_rate=1e-5)
TINY_2D_MIX = dict(rows=16, warm_steps=1, traced_steps=2)
READERS = ("gen_zero_products_pct", "conv2d_dgrad_ms_per_step")


def tiny_cell(**model) -> dict:
    cell = registry.cell(CELL)
    cell["config_data"].update(TINY_2D, **model)
    cell["traffic_data"].update(TINY_2D_MIX)
    return cell


def run_tiny(cell, traced=False) -> dict:
    return train2d.run(cell, SEED, 0.0, traced, time.time(), device="cpu")


def _correct(cell, result) -> bool:
    return run.result_line(cell, result, False)["correct"]


def test_loop_matches_the_reference():
    cell = tiny_cell()
    result = run_tiny(cell, traced=True)
    for value in result["numbers"].values():
        assert value <= 1e-4
    assert _correct(cell, result) is True
    line = run.result_line(cell, result, True)
    assert line["metrics"]["gen_zero_products_pct"]["unit"] == "%"
    assert "conv2d_dgrad_ms_per_step" not in line["metrics"]  # no device
    assert result["context"]["traced_steps"] == 2


def test_state_unchanged(monkeypatch):
    from calciumgan_tpu_torch.algorithms import wgan_gp
    monkeypatch.setattr(wgan_gp, "apply_updates", lambda net, grads: None)
    cell = tiny_cell()
    result = run_tiny(cell)
    assert result["numbers"]["change_gap"] == 1.0
    assert not _correct(cell, result)


def test_half_the_batch_shows_in_the_readings(monkeypatch):
    """Half the batch left out moves ``grad_gap`` and ``first_grad_gap``
    far past the sound run's, and the cell's limits refuse it."""
    from calciumgan_tpu_torch.algorithms import wgan_gp
    sound = run_tiny(tiny_cell())["numbers"]
    step = wgan_gp.WGAN_GP.train_step
    monkeypatch.setattr(wgan_gp.WGAN_GP, "train_step",
                        lambda self, state, real, draws: step(
                            self, state, real[:real.shape[0] // 2], draws))
    cell = tiny_cell()
    result = run_tiny(cell)
    for name in ("grad_gap", "first_grad_gap"):
        assert result["numbers"][name] > 0.1 > 100 * sound[name]
    line = run.result_line(cell, result, False)
    assert line["checks"]["first_grad_gap"]["value"] > \
        registry.limits(CELL)["first_grad_gap"]
    assert _correct(cell, result) is False


@pytest.mark.parametrize("kind", ["fp8", "half_batch"])
def test_reference_control_and_fault_show_in_the_readings(kind):
    """The reference with fp8 products, or over half the batch, in the
    program's place: ``grad_gap`` far past float32 rounding at this size,
    and ``correct`` false under the cell's limits."""
    cell = tiny_cell(num_units=8, kernel_size=8)
    cfg, mix = cell["config_data"], cell["traffic_data"]
    ref = train2d.reference_readings(cfg, mix, SEED, "cpu")
    kw = ({"cast": model.fp8_cast} if kind == "fp8"
          else {"rows": mix["batch_size"] // 2})
    other = train2d.reference_readings(cfg, mix, SEED, "cpu", **kw)
    numbers = train2d.numbers(other, ref)
    assert numbers["grad_gap"] > 0.1
    correct, checks = compare.judge(numbers, registry.limits(CELL))
    assert checks["first_grad_gap"]["value"] > \
        checks["first_grad_gap"]["limit"]
    assert correct is False


def _leaves(**norms) -> dict:
    """``{discriminator/<leaf>: [norm, 0]}``."""
    return {f"discriminator/{k}": np.array([v, 0.0])
            for k, v in norms.items()}


def test_first_grad_gap_by_hand():
    ref = _leaves(a=4.0, b=2.0, c=0.5, out=1e-5)
    prog = {**ref, "discriminator/a": np.array([4.0, 0.3]),
            "discriminator/c": np.array([0.5, -0.1]),
            "discriminator/out": np.array([1.0, 0.0])}
    # median leaf 1.25: a's gap 0.3 / 4, c's 0.1 / 1.25; the silent
    # output leaf (under a thousandth of it) is left out
    assert train2d.first_grad_gap(prog, ref) == pytest.approx(0.08)
    assert train2d.first_grad_gap(ref, ref) == 0.0


@pytest.mark.parametrize("broken", ["nan", "missing"])
def test_first_grad_gap_of_a_broken_gradient(broken):
    ref = _leaves(a=4.0, b=2.0, c=0.5)
    prog = dict(ref)
    if broken == "nan":
        prog["discriminator/b"] = np.array([np.nan, 0.0])
    else:
        del prog["discriminator/b"]
    gap = train2d.first_grad_gap(prog, ref)
    assert not gap <= registry.limits(CELL)["first_grad_gap"]


def test_the_registry_finds_the_cell():
    cell = registry.cell(CELL)
    assert cell["chips"] == 1
    assert cell["config_data"]["model"] == "calciumgan2d"
    assert cell["traffic_data"]["loop"] == "train2d"
    assert set(registry.limits(CELL)) == {"change_gap", "first_grad_gap"}
    e2e = {m["name"] for m in registry.metrics_for("end_to_end", CELL)}
    assert e2e == {"train_samples_per_s", "train_step_p90_ms", "setup_s"}
    layer = {m["name"] for m in registry.metrics_for("per_layer", CELL)}
    assert layer == {"train_mfu_pct", "device_idle_pct.train", *READERS}
    for name in layer:
        assert callable(registry.reader(name))


@pytest.fixture
def counted(monkeypatch):
    from calciumgan_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "totals", collections.Counter({
        "conv_transpose2d/products": 400,
        "conv_transpose2d/work_products": 150}))


def test_zero_share_reader(counted):
    assert registry.reader("gen_zero_products_pct")({}) == pytest.approx(
        62.5)


def test_zero_share_reader_before_any_call(monkeypatch):
    from calciumgan_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "totals", collections.Counter())
    assert registry.reader("gen_zero_products_pct")({}) is None


def test_zero_share_reader_without_the_program_counters(monkeypatch):
    monkeypatch.setitem(sys.modules, "calciumgan_tpu_torch.utils.tracing",
                        None)
    assert registry.reader("gen_zero_products_pct")({}) is None


def _window(kernels: dict) -> dict:
    return {"kernel_seconds": kernels, "busy_s": 1.0, "window_s": 1.0}


def test_dgrad_reader():
    ctx = {"traced_steps": 3, "traces": [_window({
        "void dgrad_engine<__nv_bfloat16, 128, 6, 7>(int)": 0.6,
        "sm90_xmma_dgrad_implicit_gemm_bf16": 0.3,
        "sm80_xmma_fprop_implicit_gemm_bf16": 2.0})]}
    assert registry.reader("conv2d_dgrad_ms_per_step")(ctx) == \
        pytest.approx(300.0)


@pytest.mark.parametrize("ctx", [
    {}, {"traced_steps": 3, "traces": [None]},
    {"traced_steps": 3, "traces": [_window({"fprop": 1.0})]},
    {"traces": [_window({"dgrad_engine": 1.0})]}],
    ids=["no_trace", "untraced", "no_dgrad_kernel", "no_steps"])
def test_dgrad_reader_without_its_input(ctx):
    assert registry.reader("conv2d_dgrad_ms_per_step")(ctx) is None


# noise 2, units 1, kernel 3, 1 channel, 32 frames x 4 neurons, stride 2:
# the generator widens 1 x 2 positions through filters 5, 3, 2, 1, 1 (the
# neurons doubled at layer 2); the critic narrows 32 x 4 at stride (4, 1)
CFG = dict(noise_dim=2, num_units=1, kernel_size=3, num_channels=1,
           sequence_length=32, num_neurons=4, strides=2, n_critic=5)


def test_generator_work_by_hand():
    B = 3
    dense0 = 2 * B * 2 * (1 * 2 * 2)  # noise 2 -> 1 x 2 positions x 2
    # input positions x kernel 3 x 3 x Cin x Cout, without the zeros
    convs = 2 * B * 9 * (2 * 2 * 5 + 4 * 5 * 3 + 8 * 3 * 2 + 32 * 2 * 1
                         + 64 * 1 * 1)
    dense1 = 2 * B * 32 * 4 * 1 * 1
    assert work2d.generator_flops(CFG, B) == dense0 + convs + dense1
    products, work = work2d.generator_products(CFG, B)
    assert 2 * work == convs
    # the zeros: sh * sw = 2 but at layer 2, 4
    assert 2 * products == 2 * B * 9 * 2 * (2 * 2 * 5 + 4 * 5 * 3 + 2 * 8
                                            * 3 * 2 + 32 * 2 * 1 + 64 * 1)


def test_critic_work_by_hand():
    B = 3
    # output positions (ceil(T/4) x 4 neurons) x 16 x 16 x Cin x Cout
    convs = 2 * B * 256 * 4 * (8 * 1 * 1 + 2 * 1 * 2 + 1 * 2 * 3
                               + 1 * 3 * 4 + 1 * 4 * 5)
    dense = 2 * B * (1 * 4 * 5)
    assert work2d.critic_flops(CFG, B) == convs + dense


def test_train_step_work():
    G, D = work2d.generator_flops(CFG, 4), work2d.critic_flops(CFG, 4)
    assert work2d.train_step_flops(CFG, 4) == 5 * (G + 10 * D) + 3 * G + 2 * D


def test_recipe_step_work():
    cfg = registry.cell(CELL)["config_data"]
    per_sample = work2d.train_step_flops(cfg, 1)
    assert math.isclose(work2d.train_step_flops(cfg, 4), 4 * per_sample)
    assert per_sample == pytest.approx(17.55e12, rel=1e-3)


@pytest.mark.card
def test_cell_runs_correct_on_the_card(card):
    import json
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", CELL,
         "--seed", str(2 ** 33 + 7), "--seconds", "3", "--trace", "0"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
