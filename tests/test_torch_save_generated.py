"""``--save_generated`` in the port's trainer, then the port's
``compute_metrics`` on the run it leaves: the paper's pipeline from training
to spike statistics, on the CPU at a tiny size.

The policy is the JAX package's (``calciumgan_tpu/train.py:165-209``):
``all`` saves on every ``--checkpoint_every``-th and on the last epoch,
``last`` on the last epoch only; the tail batch's filler rows are dropped; a
resumed run that validates an epoch again replaces its file. The validation
cache holds the dataset's own rows, denormalised. The JAX trainer's files
for the same dataset have the same names, shapes and cache.
"""

import os

import numpy as np
import pytest
import torch

import main as jax_main
from calciumgan_tpu import train as jax_train
from calciumgan_tpu.data import segments as jax_segments
from calciumgan_tpu.utils import h5 as jax_h5
from calciumgan_tpu_torch import compute_metrics as port_metrics
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch import train as port_train
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data import pipeline
from calciumgan_tpu_torch.utils import h5, io

torch.set_num_threads(1)

VAL = 20  # not a multiple of the batch size: the tail batch is padded


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """120 train and 20 validation rows of 64 x 6, normalised."""
    out = str(tmp_path_factory.mktemp("data") / "records")
    rng = np.random.default_rng(7)
    data = {"signals": rng.random((6, 1232)).astype(np.float32),
            "oasis": (rng.random((6, 1232)) < 0.05).astype(np.float32)}
    signals, spikes, meta = jax_segments.preprocess(
        data, 64, 8, do_normalize=True, is_dg_data=True)
    jax_segments.write_dataset(out, signals, spikes, meta, 64, 8,
                               validation_size=VAL, do_normalize=True,
                               apply_fft=False, conv2d=False, verbose=0)
    return out


def flags(records, out, epochs, *extra):
    return ["--input_dir", records, "--output_dir", out, "--batch_size", "8",
            "--num_units", "2", "--kernel_size", "4", "--noise_dim", "4",
            "--epochs", str(epochs), "--n_critic", "2", "--m", "2",
            "--layer_norm", "--checkpoint_every", "2", "--verbose", "0",
            *extra]


@pytest.mark.parametrize("epochs,policy,saved", [
    (4, "all", [0, 2, 3]), (3, "last", [2]), (2, "", [])])
def test_saves_generated_follows_the_jax_policy(epochs, policy, saved):
    cfg = Config(epochs=epochs, save_generated=policy, checkpoint_every=2)
    assert [e for e in range(epochs)
            if port_train.saves_generated(cfg, e)] == saved


@pytest.mark.parametrize("suffix", [".h5", ".npys"])
def test_save_generated_run_then_compute_metrics(records, tmp_path,
                                                 monkeypatch, suffix):
    monkeypatch.setattr(h5, "have_h5py", lambda: suffix == ".h5")
    run = str(tmp_path / "run")
    port_main.cli(flags(records, run, 3, "--save_generated", "all",
                        "--device", "cpu"))
    generated = os.path.join(run, "generated")
    assert sorted(os.listdir(generated)) == [
        "epoch000_signals" + suffix, "epoch002_signals" + suffix, "info.pkl",
        "validation" + suffix]
    cfg = Config(output_dir=run).load()
    assert cfg.validation_cache == os.path.join(generated,
                                                "validation" + suffix)
    info = io.load_generated_info(cfg)
    assert sorted(info) == [0, 2]
    assert [info[e]["global_step"] for e in (0, 2)] == [15, 45]

    # the cache is the dataset's validation split, denormalised
    data_cfg = Config(input_dir=records)
    _, validation = pipeline.get_datasets(data_cfg)
    lo, hi = data_cfg.signals_min, data_cfg.signals_max
    np.testing.assert_allclose(
        h5.get(cfg.validation_cache, "signals"),
        np.asarray(validation.signals) * (hi - lo) + lo, rtol=1e-6)
    cached = h5.get(cfg.validation_cache, "spikes")
    assert cached.dtype == np.int8
    np.testing.assert_array_equal(cached, np.asarray(validation.spikes))

    # VAL rows per epoch file: the tail batch's 4 filler rows are dropped
    first = h5.get(info[0]["filename"], "signals")
    assert first.shape == (VAL, 64, 6) and first.dtype == np.float32
    assert np.isfinite(first).all()
    assert lo <= first.min() and first.max() <= hi
    assert not np.array_equal(first[-1], first[-2])

    # a resumed run validates epoch 2 again (its checkpoint is the newest)
    # ... and replaces the file instead of doubling it
    os.remove(os.path.join(run, "checkpoints", "epoch-002.pt"))
    with open(os.path.join(run, "checkpoints", "latest.json"), "w") as f:
        f.write('{"epoch": 0, "global_step": 15}')
    before = h5.get(info[2]["filename"], "signals")
    port_main.cli(flags(records, run, 3, "--save_generated", "all",
                        "--device", "cpu"))
    again = h5.get(info[2]["filename"], "signals")
    assert again.shape == (VAL, 64, 6)
    np.testing.assert_array_equal(again, before)  # the same seeds and steps

    # the port's compute_metrics runs on what the port's trainer left
    config, options = port_metrics.parse_args(
        ["--output_dir", run, "--all_epochs", "--no_plots", "--device",
         "cpu", "--verbose", "0"])
    results = port_metrics.main(config, **options)
    assert sorted(results) == [0, 2] and config.num_samples == VAL
    for epoch in results:
        assert set(results[epoch]) == {"firing_rate_kl", "correlation_kl",
                                       "van_rossum_kl"}
        assert np.isfinite(results[epoch]["firing_rate_kl"])
        assert h5.get_shape(info[epoch]["filename"], "spikes") == (VAL, 64, 6)
    assert os.path.exists(os.path.join(run, "metrics", "metrics.json"))


def test_save_generated_last_and_the_jax_trainers_files(records, tmp_path):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    port_main.cli(flags(records, ours, 2, "--save_generated", "last",
                        "--device", "cpu"))
    jax_train.main(jax_main.parse_args(
        flags(records, theirs, 2, "--save_generated", "last")))
    names = sorted(os.listdir(os.path.join(theirs, "generated")))
    assert sorted(os.listdir(os.path.join(ours, "generated"))) == names == [
        "epoch001_signals.h5", "info.pkl", "validation.h5"]
    for name in ("signals", "spikes"):  # the same cache, read by either
        np.testing.assert_array_equal(
            jax_h5.get(os.path.join(ours, "generated", "validation.h5"),
                       name),
            h5.get(os.path.join(theirs, "generated", "validation.h5"), name))
    shapes = [jax_h5.get_shape(os.path.join(run, "generated",
                                            "epoch001_signals.h5"), "signals")
              for run in (ours, theirs)]
    assert shapes == [(VAL, 64, 6)] * 2
    ours_info = io.load_generated_info(Config(output_dir=ours))
    theirs_info = io.load_generated_info(Config(output_dir=theirs))
    assert ours_info[1]["global_step"] == theirs_info[1]["global_step"] == 30
