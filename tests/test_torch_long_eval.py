"""The port's evaluation path on long sequences (T > 4096 frames, what a
time-parallel run's epoch files hold) against the JAX package's, on the
CPU.

Held, on run directories of 4 trials x 4608 frames x 8 neurons made from a
numpy seed:

- the ``compute_metrics`` CLI gives every mean KL (firing rate,
  covariance, correlation, van Rossum, Victor-Purpura) within the 1e-4
  bound of ``tests/test_torch_eval.py`` of the JAX CLI's, and the same
  ``best_epoch``, in either container (``.h5``, ``.npys``); every
  per-pair statistic of the epoch file's spikes within 1e-4 of JAX's too;
- the dispatch's long route, ``_ladder_spikes`` with ``_long_ladder(T)``
  and the plain version ``oasis_ar1_long_torch`` (what the CUDA route
  runs, on a CPU tensor): the rungs it climbs are those the depth flags
  ask for, and its spikes equal the C++ float64 kernel's;
- ``deconvolve_file`` at T > 4096: any chunking gives the JAX package's
  spikes, and a resume keeps the complete chunks and redoes the last.

The KLs are of seeded synthetic data and say nothing of a generator.
"""

import argparse
import collections
import json
import os
import pickle

import numpy as np
import pytest
import torch

import compute_metrics as jax_cli
from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.eval import spike_eval as jax_eval
from calciumgan_tpu.utils import h5 as jax_h5
from calciumgan_tpu_torch import compute_metrics as port_cli
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.eval import spike_eval
from calciumgan_tpu_torch.ops import golden
from calciumgan_tpu_torch.ops import oasis as dispatch
from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
from calciumgan_tpu_torch.utils import h5

torch.set_num_threads(1)

N, W, C = 4, 4608, 8
EPOCHS = (3, 6)
KL_TOL = 1e-4     # tests/test_torch_eval.py's bound, on KLs and statistics


def traces_nwc(rng, n, rate):
    """``n`` trials of seeded AR(1) calcium (``golden.synth_ar1_traces``)
    as float32 NWC."""
    flat = golden.synth_ar1_traces(rng, n * C, W, rate=rate)
    return np.ascontiguousarray(flat.reshape(n, C, W).transpose(0, 2, 1))


def make_run(root, writer, suffix):
    """A run directory of ``N`` trials of ``W`` frames: a validation cache
    with spikes by the C++ float64 kernel, one epoch file per epoch of
    ``EPOCHS`` (signals only), ``info.pkl`` and ``hparams.json``, written by
    the JAX package (``.h5``) or by the port."""
    config_cls, files = ((JaxConfig, jax_h5) if writer == "jax"
                         else (Config, h5))
    cfg = config_cls(output_dir=str(root), sequence_length=W, num_neurons=C,
                     num_channels=C, signal_shape=(W, C), validation_size=N,
                     batch_size=2, verbose=0)
    gen_dir = os.path.join(cfg.output_dir, "generated")
    os.makedirs(gen_dir)
    cfg.generated_dir = gen_dir
    cfg.validation_cache = os.path.join(gen_dir, "validation" + suffix)
    rng = np.random.default_rng(4608)
    real = traces_nwc(rng, N, 0.02)
    spikes = dispatch._exact_spikes_host(
        real.transpose(0, 2, 1).reshape(-1, W), 0.95, 0.55, 0.5)
    files.write(cfg.validation_cache, {
        "signals": real, "spikes": np.ascontiguousarray(
            spikes.reshape(N, C, W).transpose(0, 2, 1))})
    info = {}
    for epoch, rate in zip(EPOCHS, (0.04, 0.025)):
        name = os.path.join(gen_dir, f"epoch{epoch:03d}_signals{suffix}")
        files.write(name, {"signals": traces_nwc(rng, N, rate)})
        info[epoch] = {"global_step": 10 * epoch, "filename": name}
    with open(os.path.join(gen_dir, "info.pkl"), "wb") as f:
        pickle.dump(info, f)
    cfg.save()
    return cfg, info


def metrics_json(run):
    with open(os.path.join(run, "metrics", "metrics.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI on a run it wrote: the run, its ``metrics.json`` and the
    config it drew."""
    run = str(tmp_path_factory.mktemp("jax") / "run")
    make_run(run, "jax", ".h5")
    config = JaxConfig.from_args(argparse.Namespace(
        output_dir=run, all_epochs=True, verbose=0, seed=12,
        num_neuron_plots=3, num_trial_plots=2))
    jax_cli.main(config, with_covariance=True, with_victor_purpura=True,
                 no_plots=True)
    return run, metrics_json(run), config


@pytest.mark.parametrize("suffix", [".h5", ".npys"])
def test_cli_equals_jax_on_long_epoch_files(tmp_path, jax_run, suffix):
    theirs_run, theirs, theirs_cfg = jax_run
    run = str(tmp_path / "run")
    _, info = make_run(run, "port", suffix)
    config, options = port_cli.parse_args(
        ["--output_dir", run, "--all_epochs", "--no_plots", "--covariance",
         "--victor_purpura", "--device", "cpu", "--verbose", "0",
         "--num_neuron_plots", "3", "--num_trial_plots", "2"])
    calls = oasis_torch.calls
    port_cli.main(config, **options)
    # long traces on the CPU take the exact host kernel, as JAX's do
    assert oasis_torch.calls == calls
    assert config.neurons == theirs_cfg.neurons
    assert config.trials == theirs_cfg.trials
    assert config.num_samples == theirs_cfg.num_samples == N
    ours = metrics_json(run)
    assert sorted(ours["epochs"]) == sorted(theirs["epochs"]) == ["3", "6"]
    for epoch, values in ours["epochs"].items():
        assert list(values) == list(theirs["epochs"][epoch]) == [
            "firing_rate_kl", "covariance_kl", "correlation_kl",
            "van_rossum_kl", "victor_purpura_kl"]
        for key, value in values.items():
            assert np.isfinite(value), (epoch, key)
            assert abs(value - theirs["epochs"][epoch][key]) <= KL_TOL, (
                epoch, key, value, theirs["epochs"][epoch][key])
    assert ours["best_epoch"] == theirs["best_epoch"]
    # the epoch files' spikes are JAX's, and so is every per-pair
    # statistic of them
    for epoch in EPOCHS:
        name = f"epoch{epoch:03d}_signals"
        spikes = h5.get(info[epoch]["filename"], "spikes")
        assert spikes.shape == (N, W, C) and spikes.dtype == np.int8
        np.testing.assert_array_equal(spikes, jax_h5.get(os.path.join(
            theirs_run, "generated", name + ".h5"), "spikes"))
        x = torch.from_numpy(spikes.astype(np.float32))
        # the rates bit for bit: a rate on a histogram edge moves its KL
        np.testing.assert_array_equal(
            spike_eval._firing_rates_nwc(x).numpy(),
            np.asarray(jax_eval._firing_rates_nwc(x.numpy())))
        for ours_fn, jax_fn in (
                (spike_eval._firing_rates_nwc, jax_eval._firing_rates_nwc),
                (spike_eval._per_trial_upper_cov,
                 jax_eval._per_trial_upper_cov),
                (spike_eval._per_trial_upper_corr,
                 jax_eval._per_trial_upper_corr),
                (spike_eval._per_trial_upper_van_rossum,
                 jax_eval._per_trial_upper_van_rossum)):
            np.testing.assert_allclose(
                ours_fn(x).numpy(), np.asarray(jax_fn(x.numpy())),
                rtol=0, atol=KL_TOL)


def overflowing(rng, rows, pools):
    """``rows`` traces of ``W`` frames whose first ``pools`` frames rise by
    0.6 a frame (more than s_min: no pool merges, so the stack holds
    ``pools`` pools), then seeded AR(1) calcium."""
    y = golden.synth_ar1_traces(rng, rows, W)
    y[:, :pools] = 0.6 * np.arange(pools, dtype=np.float32)
    return y


@pytest.mark.parametrize("case,rungs", [("spiky", 1), ("deeper", 2),
                                        ("deepest", 3)])
def test_long_ladder_climbs_as_the_depth_flags_ask(monkeypatch, case, rungs):
    """The CUDA route's decisions, run on the plain version: the long
    ladder of 4608 frames is (256, 512, 1024); a batch climbs one rung
    while more than 10% of its traces overflow (redo bit 0)."""
    ladder = dispatch._long_ladder(W)
    assert ladder == (256, 512, 1024)
    rng = np.random.default_rng(11)
    y = golden.synth_ar1_traces(rng, 6, W)
    if case == "deeper":     # 2 of 6 overflow 256 rows, none 512
        y[:2] = overflowing(rng, 2, 400)
    elif case == "deepest":  # 1 of 6 overflows 1024 rows: the host redoes it
        y[:2] = overflowing(rng, 2, 700)
        y[2] = overflowing(rng, 1, 1100)[0]
    seen = []

    def spy(signals, **kw):
        out = oasis_torch.oasis_ar1_long_torch(signals, **kw)
        seen.append((kw["depth"], out[2].numpy()))
        return out

    monkeypatch.setattr(oasis_cuda, "oasis_ar1_long", spy)
    stats = collections.Counter()
    spikes = dispatch._ladder_spikes(torch.from_numpy(y), ladder,
                                     oasis_cuda.oasis_ar1_long, True, 0.95,
                                     0.55, 0.5, stats)
    assert [d for d, _ in seen] == list(ladder[:rungs])
    shares = [float(((redo & 1) != 0).mean()) for _, redo in seen]
    # every rung but the last was asked for by its depth flags
    assert all(s > dispatch._ESCALATE_FRAC for s in shares[:-1])
    assert shares[-1] <= dispatch._ESCALATE_FRAC or rungs == len(ladder)
    assert stats["traces"] == 6
    assert stats["flagged"] == int((seen[-1][1] != 0).sum())
    np.testing.assert_array_equal(
        spikes, dispatch._exact_spikes_host(y, 0.95, 0.55, 0.5))
    if case == "deepest":
        assert seen[-1][1][2] & 1  # still too deep: the host redid it


@pytest.mark.parametrize("suffix", [".h5", ".npys"])
def test_deconvolve_file_chunks_and_resume_at_long_T(tmp_path, suffix):
    cfg, info = make_run(str(tmp_path / "run"), "port", suffix)
    name = info[EPOCHS[0]]["filename"]
    jax_copy = str(tmp_path / "jax.h5")
    jax_h5.write(jax_copy, {"signals": h5.get(name, "signals")})
    jax_eval.deconvolve_file(JaxConfig(num_neurons=C, verbose=0), jax_copy)
    theirs = jax_h5.get(jax_copy, "spikes")
    assert theirs.sum() > 0
    # auto chunk on the CPU (512 traces: all 4 trials), then one trial a
    # chunk: JAX's spikes either way
    spike_eval.deconvolve_file(cfg, name)
    np.testing.assert_array_equal(h5.get(name, "spikes"), theirs)
    h5.delete(name, "spikes")
    seconds = spike_eval.deconvolve_file(cfg, name, chunk=1)
    np.testing.assert_array_equal(h5.get(name, "spikes"), theirs)
    # the exact host kernel: no kernel stage, no flags
    assert "kernel" not in seconds and "flagged" not in seconds
    assert seconds["deconvolve"] > 0
    # resume: three complete chunks of ones staged; the first two are kept,
    # the last (possibly torn) and the fourth redone
    h5.delete(name, "spikes")
    h5.write(name, {"_spikes_partial_c1": np.ones((3, W, C), np.int8)})
    spike_eval.deconvolve_file(cfg, name, chunk=1)
    resumed = h5.get(name, "spikes")
    assert (resumed[:2] == 1).all()
    np.testing.assert_array_equal(resumed[2:], theirs[2:])
    assert h5.keys(name) == ["signals", "spikes"]


@pytest.mark.parametrize("frames", [2048, 4608, 16384, 20000])
def test_firing_rates_equal_jax_bit_for_bit(frames):
    """JAX's jitted rate is the count times the float32 reciprocal of the
    duration (XLA's rewrite of a division by a constant): inexact at 4608
    and 20,000 frames, where a plain quotient differs by an ulp."""
    counts = np.arange(0, frames + 1, max(1, frames // 1000))
    spikes = (np.arange(frames)[None, :, None]
              < counts[:, None, None]).astype(np.float32)
    theirs = np.asarray(jax_eval._firing_rates_nwc(spikes))
    np.testing.assert_array_equal(
        spike_eval._firing_rates_nwc(torch.from_numpy(spikes)).numpy(),
        theirs)
    quotient = counts.astype(np.float32) / np.float32(frames / 24)
    assert (theirs[:, 0] != quotient).any() == (frames in (4608, 20000))
