"""The serving slice as a whole: a JAX-trained checkpoint through the port.

A tiny JAX run trains for one epoch (``tests/test_train.py:279-299``
drives the JAX ``generate.py`` the same way); the port imports its
checkpoint with ``import_jax_checkpoint`` and generates on the CPU from the
same numpy noise as JAX's ``algo.generate`` + ``reverse_preprocessing``.
Signals must agree within the float32 bound of ``test_torch_models.py``
(1e-5), with the EMA params picked when the run kept an EMA. The port's CLI
must write float32 signals and int8 spikes equal to the f64 golden of its
own signals.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu import train as train_lib
from calciumgan_tpu.algorithms.registry import get_algorithm
from calciumgan_tpu.config import Config
from calciumgan_tpu.data import pipeline as jax_pipeline
from calciumgan_tpu.data import segments
from calciumgan_tpu.models.registry import get_models as jax_get_models
from calciumgan_tpu.ops import oasis_ref
from calciumgan_tpu.utils import checkpoint as jax_checkpoint
from calciumgan_tpu.utils import h5
from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch.algorithms import gan
from calciumgan_tpu_torch.data.pipeline import reverse_preprocessing
from calciumgan_tpu_torch.utils.checkpoint import (import_jax_checkpoint,
                                                   latest_epoch)

torch.set_num_threads(1)

F32_TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["raw", "ema"])
def run_dir(request, tmp_path_factory):
    """One-epoch JAX training run (checkpoint at epoch 0)."""
    from main import parse_args
    tmp = tmp_path_factory.mktemp(f"run_{request.param_index}")
    rng = np.random.default_rng(1234)
    data = {"signals": rng.random((4, 800)).astype(np.float32),
            "oasis": (rng.random((4, 800)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, do_normalize=True, is_dg_data=True)
    records = str(tmp / "records")
    segments.write_dataset(records, signals, spikes, meta, 32, 8,
                           validation_size=16, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    cfg = parse_args([
        "--input_dir", records, "--output_dir", str(tmp / "run"),
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "1", "--n_critic", "2",
        "--model", "calciumgan", "--algorithm", "wgan-gp",
        # a large step so the EMA (lagging ~one update) differs visibly
        "--learning_rate", "1e-2", "--ema", str(request.param),
        "--verbose", "0"])
    train_lib.main(cfg)
    return cfg.output_dir


def jax_state(run):
    cfg = Config(output_dir=run, verbose=0)
    cfg.load()
    generator, discriminator = jax_get_models(cfg)
    algo = get_algorithm(cfg, generator, discriminator)
    state = algo.init_state(jax.random.PRNGKey(0))
    state, epoch = jax_checkpoint.restore(
        os.path.join(run, "checkpoints"), state, verbose=0)
    assert epoch == 0
    return cfg, algo, state


def port_signals(cfg, run, noise, ema):
    params, epoch = import_jax_checkpoint(os.path.join(run, "checkpoints"),
                                          ema=ema)
    assert epoch == 0
    generator = generate_mod.build_generator(cfg, params, "cpu")
    fake = gan.generate(generator, torch.from_numpy(noise))
    return reverse_preprocessing(cfg, fake).numpy()


def test_imported_checkpoint_matches_jax_generate(run_dir):
    cfg, algo, state = jax_state(run_dir)
    noise = np.random.default_rng(3).standard_normal(
        (12, cfg.noise_dim)).astype(np.float32)
    ref = jax_pipeline.reverse_preprocessing(
        cfg, np.asarray(algo.generate(state, jnp.asarray(noise))))
    out = port_signals(cfg, run_dir, noise, ema=cfg.ema > 0)
    assert out.shape == ref.shape == (12,) + tuple(cfg.signal_shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)

    # the raw generator (generate.py --ema 0) as well
    raw, _ = algo.gen_apply(state.generator.params, {}, jnp.asarray(noise),
                            jax.random.PRNGKey(0), False)
    raw = jax_pipeline.reverse_preprocessing(cfg, np.asarray(raw))
    np.testing.assert_allclose(port_signals(cfg, run_dir, noise, ema=False),
                               raw, rtol=0, atol=F32_TOL)
    if cfg.ema > 0:  # the EMA really is other params than the raw ones
        assert np.abs(raw - ref).max() > 100 * F32_TOL
    else:
        np.testing.assert_array_equal(raw, ref)


def test_cli_writes_signals_and_golden_spikes(run_dir, tmp_path):
    out = str(tmp_path / "samples.h5")
    generate_mod.cli(["--output_dir", run_dir, "--num_samples", "10",
                      "--batch_size", "4", "--spikes", "--device", "cpu",
                      "--out", out, "--verbose", "0"])
    signals, spikes = h5.get(out, "signals"), h5.get(out, "spikes")
    cfg = Config(output_dir=run_dir, verbose=0).load()
    assert signals.shape == (10,) + tuple(cfg.signal_shape)
    assert signals.dtype == np.float32 and np.isfinite(signals).all()
    assert spikes.shape == signals.shape and spikes.dtype == np.int8
    T = signals.shape[1]
    traces = np.transpose(signals, (0, 2, 1)).reshape(-1, T)
    golden = oasis_ref.deconvolve_signals_ref(traces.astype(np.float64))
    golden = np.transpose(golden.reshape(10, -1, T), (0, 2, 1))
    np.testing.assert_array_equal(spikes, golden.astype(np.int8))

    # the CLI writes what the library core yields for the same seed
    params, _ = import_jax_checkpoint(os.path.join(run_dir, "checkpoints"),
                                      ema=cfg.ema > 0)
    core = np.concatenate([p["signals"] for p in generate_mod.generate(
        cfg, params, 10, batch_size=4, device="cpu")])
    np.testing.assert_array_equal(core, signals)


def test_latest_epoch_prefers_latest_json(tmp_path):
    ckpt = tmp_path / "checkpoints"
    ckpt.mkdir()
    for e in (1, 3):
        (ckpt / f"epoch-{e:03d}.msgpack").write_bytes(b"")
    assert latest_epoch(str(ckpt)) == 3
    (ckpt / "latest.json").write_text('{"epoch": 1, "global_step": 7}')
    assert latest_epoch(str(ckpt)) == 1
    (ckpt / "latest.json").write_text('{"epoch": 5}')  # file missing
    assert latest_epoch(str(ckpt)) == 3
    with pytest.raises(FileNotFoundError):
        import_jax_checkpoint(str(tmp_path / "none"))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import calciumgan_tpu_torch, calciumgan_tpu_torch.generate\n"
        "import calciumgan_tpu_torch.ops.oasis_cuda\n"
        "import calciumgan_tpu_torch.dataset.spike_train_inference\n"
        "import calciumgan_tpu_torch.ops.golden, calciumgan_tpu_torch.config\n"
        "import calciumgan_tpu_torch.kernels.build\n"
        "import calciumgan_tpu_torch.utils.checkpoint\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'h5py', 'msgpack')\n"
        "       if m in sys.modules]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_only_the_port():
    # chip_smoke.py reaches the JAX package's JAX-free modules only through
    # calciumgan_tpu_torch, and never imports JAX itself
    import ast
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    tops = {name.split(".")[0] for name in names}
    assert "calciumgan_tpu_torch" in tops
    assert not tops & {"calciumgan_tpu", "jax", "flax", "optax"}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path, alone):
    # no CUDA device here: non-zero exit and no result line, whether it
    # runs in the checkout or alone in an empty directory
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _chip_smoke_tree():
    import ast
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        return ast.parse(f.read())


def test_chip_smoke_takes_phase_17_and_no_phase_imports_jax():
    # the usage guard of main() lists --phase 17 (phases 1 and 17 on four
    # GPUs); the script goes past it to the card check, where a bad phase
    # stops at the guard; no function of the script imports JAX
    import ast
    tree = _chip_smoke_tree()
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    guard = next(n for n in ast.walk(main) if isinstance(n, ast.Compare)
                 and isinstance(n.left, ast.Name) and n.left.id == "argv"
                 and isinstance(n.ops[0], ast.NotIn))
    accepted = ast.literal_eval(guard.comparators[0])
    assert ["--phase", "17"] in accepted and [] in accepted
    script = os.path.join(ROOT, "chip_smoke.py")
    for argv, said in ((["--phase", "17"], "no CUDA device"),
                       (["--phase", "18"], "usage")):
        out = subprocess.run([sys.executable, script, *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 2 and said in out.stderr, out.stderr
    functions = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]
    assert {"phase_slices", "phase_data_parallel"} <= {
        n.name for n in functions}
    for fn in functions:
        names = [a.name for n in ast.walk(fn) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(fn)
                  if isinstance(n, ast.ImportFrom) and n.module]
        tops = {name.split(".")[0] for name in names}
        assert not tops & {"calciumgan_tpu", "jax", "flax", "optax"}, fn.name
