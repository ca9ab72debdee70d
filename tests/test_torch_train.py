"""The training slice as a whole: ``python -m calciumgan_tpu_torch.main``
with ``--device cpu`` on a tiny TFRecord dataset written by the JAX
package, then resumed, then served by ``calciumgan_tpu_torch.generate``.

Held against the JAX package: the records decode to the arrays JAX's
reader gives (and records the port writes decode in JAX's with their
checksums checked); each epoch's batches are the rows JAX's
``ArrayDataset.batches`` yields for the same seed and epoch; the run's
``hparams.json`` loads in the JAX ``Config`` and its event files in the JAX
event reader. A run of 2 epochs resumed to 3 ends in the same state, bit
for bit, as 3 epochs in one run: the step draws are seeded from ``(seed,
global_step)`` and the Adam states are restored. The trace figure is
checked only where matplotlib imports.
"""

import glob
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import torch

from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.data import pipeline as jax_pipeline
from calciumgan_tpu.data import segments
from calciumgan_tpu.data import tfrecord as jax_tfrecord
from calciumgan_tpu.utils import h5
from calciumgan_tpu.utils.tb_reader import read_scalars
from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch import algorithms as port_algorithms
from calciumgan_tpu_torch import train as port_train
from calciumgan_tpu_torch.algorithms import gan
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data import pipeline, tfrecord
from calciumgan_tpu_torch.data.pipeline import reverse_preprocessing
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.utils import checkpoint, tracing

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A tiny normalised dataset: 120 train and 16 validation rows of
    64 x 6, by the JAX package's writer."""
    out = str(tmp_path_factory.mktemp("data") / "records")
    rng = np.random.default_rng(7)
    data = {"signals": rng.random((6, 1200)).astype(np.float32),
            "oasis": (rng.random((6, 1200)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(data, 64, 8,
                                                do_normalize=True,
                                                is_dg_data=True)
    segments.write_dataset(out, signals, spikes, meta, 64, 8,
                           validation_size=16, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    return out


def flags(records, out, epochs, *extra):
    return ["--input_dir", records, "--output_dir", out, "--batch_size", "8",
            "--num_units", "2", "--kernel_size", "4", "--noise_dim", "4",
            "--epochs", str(epochs), "--n_critic", "2", "--m", "2",
            "--layer_norm", "--checkpoint_every", "1", "--device", "cpu",
            "--verbose", "0", *extra]


@pytest.fixture(scope="module")
def runs(records, tmp_path_factory):
    """A run of 2 epochs resumed to 3, and one of 3 epochs at once."""
    root = tmp_path_factory.mktemp("runs")
    resumed, straight = str(root / "resumed"), str(root / "straight")
    port_main.cli(flags(records, resumed, 2))
    with open(os.path.join(resumed, "checkpoints", "latest.json")) as f:
        first = json.load(f)
    port_main.cli(flags(records, resumed, 3))
    # the profiler window (epoch 1, batches 2-6) and the weight summaries
    # must leave the trajectory as it is
    port_main.cli(flags(records, straight, 3, "--profile", "--plot_weights"))
    return resumed, straight, first


def test_reader_decodes_jax_records_and_jax_reads_ours(records, tmp_path):
    for split in ("train", "validation"):
        pattern = os.path.join(records, f"{split}-*.record")
        ours = list(tfrecord.read_signal_records(
            sorted(glob.glob(pattern))[0], (64, 6), (64, 6)))
        theirs = list(jax_tfrecord.read_signal_records(
            sorted(glob.glob(pattern))[0], (64, 6), (64, 6)))
        assert len(ours) == len(theirs) > 0
        for (s, p), (s2, p2) in zip(ours, theirs):
            np.testing.assert_array_equal(s, s2)
            np.testing.assert_array_equal(p, p2)
    rng = np.random.default_rng(1)
    sig = rng.random((5, 64, 6)).astype(np.float32)
    spk = (rng.random((5, 64, 6)) < 0.1).astype(np.float32)
    path = str(tmp_path / "ours.record")
    tfrecord.write_signal_records(path, sig, spk, [3, 0, 4])
    for rec in jax_tfrecord.read_records(path, check_crc=True):
        assert tfrecord.decode_example(rec) == jax_tfrecord.decode_example(
            rec)
    back = list(jax_tfrecord.read_signal_records(path, (64, 6), (64, 6)))
    np.testing.assert_array_equal(np.stack([s for s, _ in back]),
                                  sig[[3, 0, 4]])


def test_datasets_and_batches_equal_jax(records, tmp_path):
    ours_cfg = Config(input_dir=records, batch_size=8, seed=5)
    theirs_cfg = JaxConfig(input_dir=records, batch_size=8, seed=5)
    train, val = pipeline.get_datasets(ours_cfg)
    jtrain, jval = jax_pipeline.get_datasets(theirs_cfg)
    for a, b in ((train, jtrain), (val, jval)):
        np.testing.assert_array_equal(np.asarray(a.signals),
                                      np.asarray(b.signals))
        np.testing.assert_array_equal(np.asarray(a.spikes),
                                      np.asarray(b.spikes))
    for key in ("train_size", "validation_size", "signal_shape",
                "signals_min", "signals_max", "train_steps",
                "validation_steps", "noise_shape"):
        assert getattr(ours_cfg, key) == getattr(theirs_cfg, key), key
    for epoch in (0, 1, 7):
        ours = port_train.epoch_batches(ours_cfg, epoch)
        theirs = list(jtrain.batches(8, shuffle=True,
                                     rng=np.random.default_rng(5 + epoch),
                                     drop_remainder=True))
        assert len(ours) == len(theirs) == 120 // 8
        for idx, (signal, _) in zip(ours, theirs):
            np.testing.assert_array_equal(train.signals[idx], signal)
    # the device store and host batches gather the same rows
    idx = np.array([5, 0, 7, 7])
    np.testing.assert_array_equal(
        pipeline.DeviceStore(train.signals, "cpu").batch(idx).numpy(),
        pipeline.HostBatches(train.signals, "cpu").batch(idx).numpy())
    assert not pipeline.device_store_enabled(ours_cfg, 1, "cpu")
    ours_cfg.device_store = "on"
    assert pipeline.device_store_enabled(ours_cfg, 1, "cpu")


def test_resumed_run_equals_one_run(runs):
    resumed, straight, first = runs
    assert first == {"epoch": 1, "global_step": 30}
    with open(os.path.join(resumed, "checkpoints", "latest.json")) as f:
        assert json.load(f) == {"epoch": 2, "global_step": 45}
    for run in (resumed, straight):
        assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == [
            "epoch-000.pt", "epoch-001.pt", "epoch-002.pt", "latest.json"]
    a, b = (torch.load(os.path.join(run, "checkpoints", "epoch-002.pt"),
                       weights_only=True) for run in (resumed, straight))
    assert a["global_step"] == b["global_step"] == 45
    for net in ("generator", "discriminator"):
        assert a[net]["step"] == b[net]["step"]
        torch.testing.assert_close(a[net]["params"], b[net]["params"],
                                   rtol=0, atol=0)
        torch.testing.assert_close(a[net]["opt_state"]["state"],
                                   b[net]["opt_state"]["state"], rtol=0,
                                   atol=0)
    assert a["discriminator"]["step"] == 2 * a["generator"]["step"] == 90
    # the parameters moved and stayed finite
    c = torch.load(os.path.join(resumed, "checkpoints", "epoch-000.pt"),
                   weights_only=True)
    moved = [float((a["generator"]["params"][k] - v).abs().max())
             for k, v in c["generator"]["params"].items()]
    assert max(moved) > 0
    assert all(bool(torch.isfinite(v).all())
               for v in a["generator"]["params"].values())


def test_run_directory_reads_in_the_jax_package(runs):
    resumed, straight, _ = runs
    cfg = JaxConfig(output_dir=resumed).load()
    assert (cfg.num_units, cfg.kernel_size, cfg.m, cfg.n_critic) == (
        2, 4, 2, 2)
    assert cfg.layer_norm and cfg.signal_shape == (64, 6)
    assert "device" not in cfg.extras
    train = read_scalars(resumed)
    val = read_scalars(os.path.join(resumed, "validation"))
    for tag in ("loss/generator", "loss/discriminator",
                "loss/gradient_penalty", "signals_metrics/std", "elapse"):
        assert sorted(train[tag]) == [0, 1, 2], tag
        assert sorted(val[tag]) == [0, 1, 2], tag
        assert all(np.isfinite(v) for v in train[tag].values())
    assert train["model/trainable_parameters/generator"][0] > 0
    with open(os.path.join(straight, "profiler", "window.json")) as f:
        window = json.load(f)
    assert window["steps"] == 5 and window["wall_s"] > 0
    assert window["device_busy_share"] is None  # no device on the host
    assert os.path.exists(os.path.join(straight, "profiler", "trace.json"))
    weights = read_scalars(straight)
    assert "plots_generator/01/dense_0.weight/0_mean" in weights
    assert "plots_discriminator/01/conv.0.weight/3_max" in weights
    if importlib.util.find_spec("matplotlib"):
        plots = os.listdir(os.path.join(resumed, "validation", "plots"))
        assert "fake_traces_step000002.png" in plots
        assert "real_traces_step000000.png" in plots


@pytest.mark.parametrize("ema", [0.0, 0.5], ids=["raw", "ema"])
def test_generate_serves_the_port_checkpoint(records, tmp_path, ema):
    run = str(tmp_path / "run")
    port_main.cli(flags(records, run, 1, "--ema", str(ema),
                        "--learning_rate", "1e-2"))
    cfg = Config(output_dir=run, verbose=0).load()
    stored = torch.load(os.path.join(run, "checkpoints", "epoch-000.pt"),
                        weights_only=True)
    assert (stored["ema"] is None) == (ema == 0.0)
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 4)).astype(np.float32))

    def sample(weights):
        generator, _ = get_models(cfg)
        generator.load_state_dict(weights)
        return reverse_preprocessing(cfg, gan.generate(generator, noise))

    for use_ema in (True, False):
        params, epoch = checkpoint.restore_generator_params(
            os.path.join(run, "checkpoints"), ema=use_ema)
        assert epoch == 0
        served = reverse_preprocessing(cfg, gan.generate(
            generate_mod.build_generator(cfg, params, "cpu"), noise))
        weights = (stored["ema"] if use_ema and ema > 0
                   else stored["generator"]["params"])
        torch.testing.assert_close(served, sample(weights), rtol=0, atol=0)
    if ema > 0:  # the EMA really is other params than the raw ones
        raw = sample(stored["generator"]["params"])
        assert float((sample(stored["ema"]) - raw).abs().max()) > 1e-4

    out = str(tmp_path / "samples.h5")
    generate_mod.cli(["--output_dir", run, "--num_samples", "6",
                      "--batch_size", "4", "--spikes", "--device", "cpu",
                      "--out", out, "--verbose", "0"])
    signals, spikes = h5.get(out, "signals"), h5.get(out, "spikes")
    assert signals.shape == spikes.shape == (6, 64, 6)
    assert np.isfinite(signals).all() and spikes.dtype == np.int8


def test_trainer_refuses_what_it_cannot_run(records, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.resolve_device("cuda")  # this host has no card
    config, device = port_main.parse_args(
        flags(records, str(tmp_path / "x"), 1, "--time_parallelism", "2"))
    assert device == "cpu"
    # one device cannot hold two time ranks: the JAX trainer's message
    with pytest.raises(ValueError, match=r"time_parallelism 2 must divide "
                                         r"the device count \(1 device\(s\) "
                                         r"visible\)"):
        port_train.main(config, device=device)


@pytest.fixture(scope="module")
def conv2d_records(tmp_path_factory):
    """The records fixture's data as a ``--conv2d`` dataset: 64 x 6 x 1."""
    out = str(tmp_path_factory.mktemp("data2d") / "records")
    rng = np.random.default_rng(7)
    data = {"signals": rng.random((6, 1200)).astype(np.float32),
            "oasis": (rng.random((6, 1200)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(data, 64, 8, conv2d=True,
                                                do_normalize=True,
                                                is_dg_data=True)
    segments.write_dataset(out, signals, spikes, meta, 64, 8,
                           validation_size=16, do_normalize=True,
                           apply_fft=False, conv2d=True, verbose=0)
    return out


@pytest.mark.parametrize("extra", [
    ("--model", "mlp"), ("--model", "calciumgan2d"), ("--batch_norm",)],
    ids=["mlp", "calciumgan2d", "batch_norm"])
def test_models_the_port_builds_and_refuses(records, conv2d_records, extra):
    # every model of the JAX registry builds, --batch_norm too (the 2-D
    # model on a --conv2d dataset); a model the registry lacks is refused
    conv2d = "calciumgan2d" in extra
    config, _ = port_main.parse_args(flags(
        conv2d_records if conv2d else records, "unused", 1, *extra))
    pipeline.get_datasets(config)
    assert config.signal_shape == ((64, 6, 1) if conv2d else (64, 6))
    gen, dis = get_models(config)
    draws = gan.Draws(0, 0, "cpu")
    noise = torch.zeros(3, config.noise_dim)
    fake = gen(noise, *gen.draw_inputs(draws, 3, True))
    assert fake.shape == (3,) + tuple(config.signal_shape)
    assert dis(fake, *dis.draw_inputs(draws, 3, True)).shape == (3, 1)
    assert bool(torch.isfinite(fake).all())
    if "--batch_norm" in extra:
        assert any(n.endswith("batch_norm.var") for n, _ in
                   gen.named_buffers())
    config.model = "bogus"
    with pytest.raises(KeyError, match="bogus"):
        get_models(config)


def test_surrogate_pickle_loads_as_jax(tmp_path):
    rng = np.random.default_rng(8)
    data = {"signals": rng.random((12, 6, 64)).astype(np.float32) * 3,
            "spikes": (rng.random((12, 64, 6)) < 0.1).astype(np.float32)}
    root = tmp_path / "surrogate"
    root.mkdir()
    with open(root / "training.pkl", "wb") as f:
        pickle.dump(data, f)
    ours_cfg = Config(input_dir=str(root), batch_size=4, surrogate_ds=True)
    theirs_cfg = JaxConfig(input_dir=str(root), batch_size=4,
                           surrogate_ds=True)
    ours = pipeline.get_datasets(ours_cfg)
    theirs = jax_pipeline.get_datasets(theirs_cfg)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.signals, b.signals)
        np.testing.assert_array_equal(a.spikes, b.spikes)
    for key in ("signals_min", "signals_max", "train_size",
                "validation_size", "signal_shape", "num_neurons",
                "train_steps", "normalize"):
        assert getattr(ours_cfg, key) == getattr(theirs_cfg, key), key


def test_main_metrics_and_surrogate_set(records, tmp_path):
    config, device = port_main.parse_args(flags(
        records, str(tmp_path / "run"), 1, "--skip_checkpoints"))
    metrics = port_train.main(config, return_metrics=True, device=device)
    assert {"loss/generator", "loss/discriminator", "loss/gradient_penalty",
            "signals_metrics/std"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    assert not os.path.exists(os.path.join(str(tmp_path / "run"),
                                           "checkpoints"))
    algo = port_algorithms.get_algorithm(config, *get_models(config))
    path = port_train.generate_surrogate_dataset(
        config, algo, algo.init_state(), "cpu", num_samples=1500)
    with open(path, "rb") as f:
        generated = pickle.load(f)["signals"]
    assert generated.shape == (2000, 64, 6)  # whole batches of 1000
    lo, hi = config.signals_min, config.signals_max
    assert lo <= generated.min() and generated.max() <= hi


def test_busy_seconds_is_the_union_of_device_intervals():
    """The profile window's device-busy seconds: overlapping and nested
    intervals count once, gaps not at all (microseconds in, seconds
    out)."""
    class Event:
        def __init__(self, start, end):
            self.time_range = type("Range", (), dict(start=start, end=end))

    events = [Event(30, 40), Event(0, 10), Event(5, 20), Event(6, 8),
              Event(50, 50)]
    assert tracing.busy_seconds(events) == pytest.approx(30e-6)
    assert tracing.busy_seconds([]) == 0.0
