"""The port's evaluation path against the JAX package's on fabricated run
directories (the ``fake_run`` of ``tests/test_eval.py``, with two epoch
files), on the CPU.

A run directory is fabricated from a numpy seed by either package's writers
(``h5``, ``Config.save``), or by the port in its ``.npys`` container. Held:
``compute_epoch_spike_metrics`` and the ``compute_metrics`` CLI give every
mean KL within 1e-4 of the JAX package's on the same data and the same
``best_epoch``, whichever package wrote the directory; the deconvolved
``spikes`` equal the float64 golden model's and the JAX package's; the
``.npys`` container gives the very KLs of the ``.h5`` one. Resume, chunk
mismatch and a truncated ``spikes`` dataset behave as in the JAX package.
The KLs are of seeded synthetic data and say nothing of a generator.
"""

import argparse
import importlib.util
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
from calciumgan_tpu.utils.summary import Summary as JaxSummary
from calciumgan_tpu.utils.tb_reader import read_scalars
from calciumgan_tpu_torch import compute_metrics as port_cli
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.eval import spike_eval
from calciumgan_tpu_torch.ops import golden, oasis_torch
from calciumgan_tpu_torch.utils import h5
from calciumgan_tpu_torch.utils.summary import Summary

torch.set_num_threads(1)

N, W, C = 12, 96, 4
EPOCHS = (5, 8)
KL_TOL = 1e-4


def signals_with_spikes(rng, n, rate):
    """AR(1)-looking traces with random transients."""
    spikes = (rng.uniform(size=(n, W, C)) < rate).astype(np.float32)
    sig = np.zeros_like(spikes)
    for t in range(1, W):
        sig[:, t] = 0.95 * sig[:, t - 1] + spikes[:, t]
    sig += 0.05 * rng.normal(size=sig.shape).astype(np.float32)
    return sig.astype(np.float32), spikes


def make_run(root, writer="port", suffix=".h5"):
    """A fabricated run directory: validation cache, one epoch file per
    epoch of ``EPOCHS`` (signals only), ``info.pkl`` and ``hparams.json``,
    written by the JAX package or by the port."""
    config_cls, files = ((JaxConfig, jax_h5) if writer == "jax"
                         else (Config, h5))
    cfg = config_cls(output_dir=str(root), dpi=50, sequence_length=W,
                     num_neurons=C, num_channels=C, signal_shape=(W, C),
                     validation_size=N, batch_size=4, verbose=0)
    gen_dir = os.path.join(cfg.output_dir, "generated")
    os.makedirs(gen_dir)
    cfg.generated_dir = gen_dir
    cfg.validation_cache = os.path.join(gen_dir, "validation" + suffix)
    rng = np.random.default_rng(1234)
    real_sig, real_spk = signals_with_spikes(rng, N, 0.05)
    files.write(cfg.validation_cache, {"signals": real_sig,
                                       "spikes": real_spk.astype(np.int8)})
    info = {}
    for epoch, rate in zip(EPOCHS, (0.09, 0.06)):
        name = os.path.join(gen_dir, f"epoch{epoch:03d}_signals{suffix}")
        files.write(name, {"signals": signals_with_spikes(rng, N, rate)[0]})
        info[epoch] = {"global_step": 10 * epoch, "filename": name}
    with open(os.path.join(gen_dir, "info.pkl"), "wb") as f:
        pickle.dump(info, f)
    cfg.save()
    cfg.num_samples = N
    cfg.neurons = [0, 1, 2, 3]
    cfg.trials = [0, 1]
    cfg.num_neuron_plots = 4
    cfg.plots_per_row = 2
    return cfg, info


def epoch_metrics(package, cfg, info, epoch, no_plots=True, **flags):
    rng = np.random.default_rng(3)
    if package == "jax":
        return jax_eval.compute_epoch_spike_metrics(
            cfg, JaxSummary(cfg, spike_metrics=True, no_plots=no_plots),
            info[epoch]["filename"], epoch=epoch, rng=rng, **flags)
    summary = Summary(cfg, spike_metrics=True, no_plots=no_plots)
    out = spike_eval.compute_epoch_spike_metrics(
        cfg, summary, info[epoch]["filename"], epoch=epoch, rng=rng,
        device="cpu", **flags)
    summary.close()
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX package's KLs of epoch 5 of a run it wrote, and its files."""
    cfg, info = make_run(tmp_path_factory.mktemp("jax") / "run", "jax")
    results = epoch_metrics("jax", cfg, info, 5, with_covariance=True,
                            with_victor_purpura=True)
    return results, cfg, info


@pytest.mark.parametrize("suffix", [".h5", ".npys"])
def test_epoch_spike_metrics_equal_jax(tmp_path, jax_results, suffix):
    theirs, _, jax_info = jax_results
    cfg, info = make_run(tmp_path / "run", "port", suffix)
    calls = oasis_torch.calls
    ours = epoch_metrics("port", cfg, info, 5, with_covariance=True,
                         with_victor_purpura=True)
    assert oasis_torch.calls > calls  # the plain version ran, on the CPU
    assert list(ours) == list(theirs) == [
        "firing_rate_kl", "covariance_kl", "correlation_kl",
        "van_rossum_kl", "victor_purpura_kl"]
    for key in ours:
        assert np.isfinite(ours[key]), key
        assert abs(ours[key] - theirs[key]) <= KL_TOL, (key, ours, theirs)
    # the other epoch's KLs are far outside the bound
    seconds = {}
    other = epoch_metrics("port", cfg, info, 8, seconds=seconds)
    assert abs(other["firing_rate_kl"] - theirs["firing_rate_kl"]) > 1e-2

    # int8 NWC spikes, equal to the float64 golden's and to JAX's
    name = info[5]["filename"]
    spikes = h5.get(name, "spikes")
    assert spikes.shape == (N, W, C) and spikes.dtype == np.int8
    traces = np.transpose(h5.get(name, "signals"), (0, 2, 1)).reshape(-1, W)
    np.testing.assert_array_equal(
        np.transpose(spikes, (0, 2, 1)).reshape(-1, W),
        golden.golden_spikes(traces, g=0.95, s_min=0.55, threshold=0.5))
    np.testing.assert_array_equal(
        spikes, jax_h5.get(jax_info[5]["filename"], "spikes"))
    assert spikes.sum() > 0
    assert not any(k.startswith("_spikes_partial") for k in h5.keys(name))
    scalars = read_scalars(os.path.join(cfg.output_dir, "metrics"))
    assert scalars["spike_metrics/van_rossum_kl"][5] == pytest.approx(
        ours["van_rossum_kl"])
    assert {"deconvolve/total", "deconvolve/kernel", "load_spikes",
            "firing_rate_kl", "van_rossum_kl"} <= set(seconds)
    assert seconds["deconvolve/traces"] == N * C


def test_npys_container_gives_the_h5_containers_kls(tmp_path):
    results = []
    for suffix in (".h5", ".npys"):
        cfg, info = make_run(tmp_path / suffix[1:], "port", suffix)
        results.append(epoch_metrics("port", cfg, info, 5))
    assert results[0] == results[1]


@pytest.mark.skipif(importlib.util.find_spec("matplotlib") is None,
                    reason="figures need matplotlib")
def test_epoch_spike_metrics_render_the_figures(tmp_path, jax_results):
    cfg, info = make_run(tmp_path / "run", "port")
    ours = epoch_metrics("port", cfg, info, 5, no_plots=False)
    for key in ours:  # figures change no number
        assert abs(ours[key] - jax_results[0][key]) <= KL_TOL
    plots = os.listdir(os.path.join(cfg.output_dir, "metrics", "plots"))
    names = {p.split(".")[0] for p in plots}
    assert {"firing_rate", "firing_rate_kl", "raster_plot", "van_rossum",
            "van_rossum_kl", "correlation", "real_traces",
            "fake_traces"} <= names
    assert "van_rossum.pdf" in plots and \
        "van_rossum_step000005.png" in plots
    # a pass without figures keeps those a full pass rendered
    Summary(cfg, spike_metrics=True, no_plots=True).close()
    assert "van_rossum.pdf" in os.listdir(
        os.path.join(cfg.output_dir, "metrics", "plots"))


def test_summary_without_matplotlib_skips_figures(tmp_path, monkeypatch,
                                                  capsys):
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    cfg, _ = make_run(tmp_path / "run", "port")
    summary = Summary(cfg, spike_metrics=True)
    assert summary.no_plots
    assert "matplotlib is not installed" in capsys.readouterr().out
    summary.plot_distribution("x_kl", data=np.arange(3.0))  # renders nothing
    summary.close()
    assert not os.path.exists(os.path.join(cfg.output_dir, "metrics",
                                           "plots"))


# ---- deconvolve_file: resume, chunk mismatch, truncation, empty -------------

@pytest.fixture(params=[".h5", ".npys"])
def fake_run(tmp_path, request):
    cfg, info = make_run(tmp_path / "run", "port", request.param)
    return cfg, info[5]["filename"]


def test_ensure_spikes_redoes_truncated_dataset(fake_run):
    cfg, epoch_file = fake_run
    h5.write(epoch_file, {"spikes": np.zeros((5, W, C), np.int8)})
    assert spike_eval.ensure_spikes(cfg, epoch_file) is not None
    assert h5.get_dataset_length(epoch_file, "spikes") == N
    assert not any(k.startswith("_spikes_partial")
                   for k in h5.keys(epoch_file))
    assert h5.get(epoch_file, "spikes").sum() > 0
    # and a complete dataset is left untouched
    marker = h5.get(epoch_file, "spikes")
    assert spike_eval.ensure_spikes(cfg, epoch_file) is None
    np.testing.assert_array_equal(h5.get(epoch_file, "spikes"), marker)


def test_deconvolve_file_resumes_from_partial_chunks(fake_run):
    cfg, epoch_file = fake_run
    sentinel = np.full((8, W, C), 1, np.int8)  # two complete chunks of 4
    h5.write(epoch_file, {"_spikes_partial_c4": sentinel})
    seconds = spike_eval.deconvolve_file(cfg, epoch_file, chunk=4)
    spikes = h5.get(epoch_file, "spikes")
    assert spikes.shape == (N, W, C)
    # chunk 1 was kept verbatim (resume, not redo)
    np.testing.assert_array_equal(spikes[:4], sentinel[:4])
    # chunk 2 (possibly torn) and chunk 3 were actually deconvolved
    assert not np.all(spikes[4:] == 1)
    assert not h5.contains(epoch_file, "_spikes_partial_c4")
    assert {"read", "upload", "kernel", "write", "total"} <= set(seconds)
    # the redone chunks equal a fresh deconvolution's
    h5.delete(epoch_file, "spikes")
    spike_eval.deconvolve_file(cfg, epoch_file)
    np.testing.assert_array_equal(h5.get(epoch_file, "spikes")[4:],
                                  spikes[4:])


def test_deconvolve_file_restarts_on_chunk_mismatch(fake_run):
    cfg, epoch_file = fake_run
    h5.write(epoch_file,
             {"_spikes_partial_c16": np.full((8, W, C), 1, np.int8)})
    spike_eval.deconvolve_file(cfg, epoch_file, chunk=4)
    spikes = h5.get(epoch_file, "spikes")
    assert spikes.shape == (N, W, C)
    assert not np.all(spikes[:8] == 1)  # sentinel rows were NOT reused
    assert h5.keys(epoch_file) == ["signals", "spikes"]


def test_deconvolve_file_chunks_and_empty_file(fake_run):
    cfg, epoch_file = fake_run
    # auto chunk on the CPU: 512 traces of 4 neurons, all 12 trials at once;
    # chunks of 5 give the same spikes
    spike_eval.deconvolve_file(cfg, epoch_file)
    whole = h5.get(epoch_file, "spikes")
    h5.delete(epoch_file, "spikes")
    spike_eval.deconvolve_file(cfg, epoch_file, chunk=5)
    np.testing.assert_array_equal(h5.get(epoch_file, "spikes"), whole)
    empty = os.path.join(cfg.generated_dir,
                         "empty" + os.path.splitext(epoch_file)[1])
    h5.write(empty, {"signals": np.zeros((0, W, C), np.float32)})
    spike_eval.ensure_spikes(cfg, empty)
    assert h5.get_shape(empty, "spikes") == (0, W, C)


def test_sort_heatmap_and_chunked_equal_jax():
    rng = np.random.default_rng(5)
    m = rng.uniform(size=(6, 6)).astype(np.float32)
    ours, theirs = spike_eval.sort_heatmap(m), jax_eval.sort_heatmap(m)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[0][0, 0] == m.min()
    x = rng.normal(size=(37, 8)).astype(np.float32)
    out = spike_eval.chunked(lambda a: a * 2.0, x, chunk=16)
    np.testing.assert_array_equal(out, x * 2.0)
    spikes = torch.from_numpy(
        (rng.random((7, 48, 5)) < 0.1).astype(np.float32))
    np.testing.assert_allclose(
        spike_eval.chunked(spike_eval._per_trial_upper_van_rossum, spikes, 3),
        jax_eval.chunked(jax_eval._per_trial_upper_van_rossum,
                         spikes.numpy(), 3), atol=1e-4)
    for ours_fn, jax_fn in (
            (spike_eval._firing_rates_nwc, jax_eval._firing_rates_nwc),
            (spike_eval._per_trial_upper_corr,
             jax_eval._per_trial_upper_corr),
            (spike_eval._per_trial_upper_cov, jax_eval._per_trial_upper_cov)):
        np.testing.assert_allclose(ours_fn(spikes).numpy(),
                                   np.asarray(jax_fn(spikes.numpy())),
                                   atol=1e-5)


# ---- the CLI ----------------------------------------------------------------

def run_jax_cli(run):
    args = argparse.Namespace(output_dir=run, all_epochs=True, verbose=0,
                              seed=12, num_neuron_plots=3, num_trial_plots=2)
    config = JaxConfig.from_args(args)
    jax_cli.main(config, with_covariance=True, no_plots=True)
    return config


def run_port_cli(run, *extra):
    config, options = port_cli.parse_args(
        ["--output_dir", run, "--all_epochs", "--no_plots", "--covariance",
         "--device", "cpu", "--verbose", "0", "--num_neuron_plots", "3",
         "--num_trial_plots", "2", *extra])
    assert options["device"] == "cpu"
    port_cli.main(config, **options)
    return config


def metrics_json(run):
    with open(os.path.join(run, "metrics", "metrics.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_metrics_json_equals_jax_whoever_wrote_the_run(tmp_path, writer):
    runs = {}
    for reader in ("jax", "port"):
        runs[reader] = str(tmp_path / reader)
        make_run(runs[reader], writer)
    theirs_cfg = run_jax_cli(runs["jax"])
    ours_cfg = run_port_cli(runs["port"])
    # both CLIs drew the same neurons and trials from the seed
    assert ours_cfg.neurons == theirs_cfg.neurons and len(
        ours_cfg.neurons) == 3
    assert ours_cfg.trials == theirs_cfg.trials
    assert ours_cfg.num_samples == theirs_cfg.num_samples == N
    ours, theirs = metrics_json(runs["port"]), metrics_json(runs["jax"])
    assert sorted(ours["epochs"]) == sorted(theirs["epochs"]) == ["5", "8"]
    for epoch in ours["epochs"]:
        assert list(ours["epochs"][epoch]) == list(theirs["epochs"][epoch])
        for key, value in ours["epochs"][epoch].items():
            assert abs(value - theirs["epochs"][epoch][key]) <= KL_TOL, key
    assert ours["best_epoch"] == theirs["best_epoch"]
    assert set(ours["best_epoch"].values()) <= {5, 8}
    assert not os.path.exists(os.path.join(runs["port"], "metrics",
                                           "metrics.json.tmp"))


def test_cli_default_epoch_missing_files_and_clamp(tmp_path, capsys):
    run = str(tmp_path / "run")
    _, info = make_run(run, "port", ".npys")
    # the newest epoch's file is gone: the CLI warns and falls back; a
    # shorter epoch file clamps num_samples
    h5.remove(info[8]["filename"])
    h5.truncate(info[5]["filename"], "signals", 9)
    config, options = port_cli.parse_args(
        ["--output_dir", run, "--no_plots", "--device", "cpu",
         "--verbose", "0"])
    results = port_cli.main(config, **options)
    assert "skipping epoch 8" in capsys.readouterr().out
    assert list(results) == [5] and config.num_samples == 9
    assert metrics_json(run)["best_epoch"]["firing_rate_kl"] == 5
    h5.remove(info[5]["filename"])
    with pytest.raises(FileNotFoundError, match="--save_generated"):
        port_cli.main(config, **options)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(config, no_plots=True)  # the default device: cuda
    with pytest.raises(SystemExit):
        port_cli.cli(["--output_dir", str(tmp_path / "none"), "--device",
                      "cpu"])
