"""The port's DG command lines against the root scripts (mirror of
``tests/test_dataset_clis.py:71-83``), and the two paths they open, on the
CPU at a tiny size:

- ``generate_dg_data`` and ``generate_surrogate_data`` with the JAX
  package's normal draws handed to the port (``run(args, draws=...)``):
  spikes, ``mean`` and ``covariance`` equal, signals within the
  ``ar1_filter`` bound (1e-5 absolute, ``test_torch_dg.py``);
- ``generate_dg_data -> generate_tfrecords --is_dg_data -> main
  --save_generated last -> compute_dg_metrics``: the port's dictionary
  within 1e-5 (relative, on values up to hundreds of percent) of the root
  ``compute_dg_metrics.main`` on the same run directory, with ``.h5`` and
  ``.npys`` files;
- ``generate_surrogate_data -> main --model mlp --algorithm gan`` for one
  epoch, with ``generated.pkl``.

The recording's spike probability is 0.4 a frame: both packages pass the
data's covariance (variances ``p (1 - p)``) where the sampler takes a
correlation matrix, as the reference does, so a DG neuron fires with
``Phi(mu / sigma)`` and a sparse recording would leave no DG spike at all.
"""

import argparse
import functools
import importlib.util
import os
import pickle

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

import compute_dg_metrics as root_metrics
from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.data import pipeline as jax_pipeline
from calciumgan_tpu_torch import compute_dg_metrics as port_metrics
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch import train as port_train
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data import pipeline
from calciumgan_tpu_torch.dataset import generate_dg_data as port_dg
from calciumgan_tpu_torch.dataset import generate_surrogate_data as port_sur
from calciumgan_tpu_torch.dataset import generate_tfrecords as port_records
from calciumgan_tpu_torch.dataset import get_coordinate as port_coordinate
from calciumgan_tpu_torch.utils import h5, io

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AR_TOL = 1e-5
NEURONS, DURATION = 7, 1500


def _root(script):
    """A root ``dataset/`` script as a module (it is no package)."""
    spec = importlib.util.spec_from_file_location(
        "root_" + script, os.path.join(REPO, "dataset", script + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


root_dg = _root("generate_dg_data")
root_sur = _root("generate_surrogate_data")
root_coordinate = _root("get_coordinate")


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _recording(path, silent=None, seed=0):
    rng = np.random.default_rng(seed)
    spikes = (rng.random((NEURONS, DURATION)) < 0.4).astype(np.float32)
    if silent is not None:
        spikes[silent] = 0.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"signals": rng.random(spikes.shape).astype(np.float32),
                     "oasis": spikes}, f)
    return path


class JaxDraws:
    """The draws the root scripts make from ``--seed``, by stream, as
    ``SeededNormals.normal`` hands them out. The root surrogate script
    folds each batch's first row into its stream's key (``folded``)."""

    def __init__(self, seed, streams, folded=()):
        keys = jax.random.split(jax.random.PRNGKey(seed), len(streams))
        self.keys = dict(zip(streams, keys))
        self.rows = {stream: 0 for stream in folded}

    def normal(self, stream, shape):
        key = self.keys[stream]
        if stream in self.rows:
            key = jax.random.fold_in(key, self.rows[stream])
            self.rows[stream] += shape[0]
        return torch.from_numpy(np.array(
            jax.random.normal(key, tuple(shape), jnp.float32)))


@pytest.mark.parametrize("silent", [None, 4], ids=["dense", "silent_neuron"])
def test_generate_dg_data_equals_the_root_cli_on_its_draws(tmp_path, silent):
    raw = _recording(str(tmp_path / "raw" / "rec.pkl"), silent)
    theirs_path = str(tmp_path / "theirs" / "data.pkl")
    root_dg.main(argparse.Namespace(input=raw, output=theirs_path, seed=11))
    theirs = _load(theirs_path)

    args = port_dg.parse_args(["--input", raw, "--output",
                               str(tmp_path / "ours" / "data.pkl"),
                               "--seed", "11", "--device", "cpu"])
    seconds = {}
    found = port_dg.run(args, draws=JaxDraws(11, ("sample", "noise")),
                        seconds=seconds)
    ours = _load(args.output)
    assert set(ours) == set(theirs) == {"signals", "oasis", "mean",
                                        "covariance"}
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype, key
        assert ours[key].shape == theirs[key].shape, key
    np.testing.assert_array_equal(ours["oasis"], theirs["oasis"])
    np.testing.assert_array_equal(ours["covariance"], theirs["covariance"])
    np.testing.assert_allclose(ours["mean"], theirs["mean"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ours["signals"], theirs["signals"], rtol=0,
                               atol=AR_TOL)
    # a neuron that never fires makes the covariance singular: Higham
    assert found["projected"] == (silent is not None)
    assert ours["oasis"].sum() > 100
    assert set(seconds) == {"fit", "sample", "filter", "write"}
    # the noise is part of the signals: without it they are the calcium
    assert np.abs(ours["signals"]).max() > 1.0


def test_generate_dg_data_on_its_own_seed(tmp_path):
    raw = _recording(str(tmp_path / "raw" / "rec.pkl"))
    outs = []
    for name, seed in (("a", 5), ("b", 5), ("c", 6)):
        path = str(tmp_path / name / "data.pkl")
        port_dg.main(["--input", raw, "--output", path, "--seed", str(seed),
                      "--device", "cpu"])
        outs.append(_load(path))
    a, b, c = outs
    # the first two neurons are dropped; the duration is the recording's
    assert a["signals"].shape == a["oasis"].shape == (NEURONS - 2, DURATION)
    assert a["signals"].dtype == a["oasis"].dtype == np.float32
    assert a["mean"].shape == (1, NEURONS - 2)
    assert a["covariance"].shape == (NEURONS - 2,) * 2
    assert a["mean"].dtype == a["covariance"].dtype == np.float64
    assert set(np.unique(a["oasis"])) == {0.0, 1.0}
    assert np.isfinite(a["signals"]).all()
    recorded = _load(raw)["oasis"][2:].astype(np.float64)
    np.testing.assert_allclose(
        a["mean"][0], st.norm.ppf(recorded.mean(1)), atol=1e-9)
    for key in a:  # the same seed writes the same file, another seed not
        np.testing.assert_array_equal(a[key], b[key])
    assert (a["oasis"] != c["oasis"]).any()
    # a neuron fires with Phi(mu / sigma): the data's covariance stands in
    # for the sampler's correlation matrix (5 sigma of 1500 draws)
    expected = st.norm.cdf(a["mean"][0] / np.sqrt(np.diag(a["covariance"])))
    np.testing.assert_allclose(a["oasis"].mean(1), expected, atol=0.065)
    with pytest.raises(SystemExit):
        port_dg.main(["--input", str(tmp_path / "none.pkl"), "--output",
                      str(tmp_path / "x.pkl"), "--device", "cpu"])


def test_generate_surrogate_data_equals_the_root_cli_on_its_draws(tmp_path):
    theirs_dir, ours_dir = str(tmp_path / "theirs"), str(tmp_path / "ours")
    root_sur.main(argparse.Namespace(
        surrogate_path=os.path.join(theirs_dir, "surrogate.pkl"),
        ground_truth_path=os.path.join(theirs_dir, "ground_truth.pkl"),
        training_path=os.path.join(theirs_dir, "training.pkl"),
        output_dir=theirs_dir, num_samples=230_000, training_size=300,
        sequence_length=6, seed=9))
    os.makedirs(ours_dir)
    stale = os.path.join(ours_dir, "stale.txt")
    open(stale, "w").close()
    args = port_sur.parse_args(["--output_dir", ours_dir, "--num_samples",
                                "230000", "--training_size", "300",
                                "--seed", "9", "--device", "cpu"])
    port_sur.run(args, draws=JaxDraws(
        9, ("surrogate", "ground_truth", "noise"),
        folded=("surrogate", "ground_truth")))
    assert not os.path.exists(stale)  # the output directory is wiped first
    assert sorted(os.listdir(ours_dir)) == sorted(os.listdir(theirs_dir)) == [
        "ground_truth.pkl", "surrogate.pkl", "training.pkl"]
    for name in ("surrogate", "ground_truth"):  # three batches of draws
        ours = _load(os.path.join(ours_dir, name + ".pkl"))
        theirs = _load(os.path.join(theirs_dir, name + ".pkl"))
        assert list(ours) == list(theirs) == ["spikes"]
        assert ours["spikes"].shape == (230_000, 2, 6)
        assert ours["spikes"].dtype == theirs["spikes"].dtype == np.float32
        np.testing.assert_array_equal(ours["spikes"], theirs["spikes"])
    ours = _load(os.path.join(ours_dir, "training.pkl"))
    theirs = _load(os.path.join(theirs_dir, "training.pkl"))
    assert ours["signals"].shape == ours["spikes"].shape == (300, 2, 6)
    np.testing.assert_array_equal(ours["spikes"], theirs["spikes"])
    np.testing.assert_allclose(ours["signals"], theirs["signals"], rtol=0,
                               atol=AR_TOL)
    # mean [0.6, 0.8], unit variances: P(spike) = Phi(mean)
    np.testing.assert_allclose(
        _load(os.path.join(ours_dir, "surrogate.pkl"))["spikes"].mean((0, 2)),
        st.norm.cdf([0.6, 0.8]), atol=5e-3)


@pytest.fixture(scope="module")
def surrogate_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("data") / "surrogate")
    port_sur.main(["--output_dir", out, "--num_samples", "20000",
                   "--training_size", "8256", "--seed", "3", "--device",
                   "cpu"])
    return out


def test_surrogate_training_set_loads_in_both_packages(surrogate_dir):
    cfg = Config(input_dir=surrogate_dir, surrogate_ds=True)
    jcfg = JaxConfig(input_dir=surrogate_dir, surrogate_ds=True)
    ours = pipeline.get_datasets(cfg)
    theirs = jax_pipeline.get_datasets(jcfg)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.signals, b.signals)
        np.testing.assert_array_equal(a.spikes, b.spikes)
    assert (cfg.train_size, cfg.validation_size) == (8192, 64)
    assert cfg.signal_shape == jcfg.signal_shape == (6, 2)
    assert cfg.normalize and cfg.sequence_length == 6
    assert cfg.num_neurons == 2
    assert (cfg.signals_min, cfg.signals_max) == (jcfg.signals_min,
                                                  jcfg.signals_max)
    # the same seed gives the same rows; numpy chooses them in both
    again = _load(os.path.join(surrogate_dir, "training.pkl"))
    truth = _load(os.path.join(surrogate_dir, "ground_truth.pkl"))["spikes"]
    rows = np.random.default_rng(3).choice(len(truth), size=8256)
    np.testing.assert_array_equal(again["spikes"], truth[rows])


def test_mlp_trains_on_the_surrogate_set(surrogate_dir, tmp_path,
                                         monkeypatch):
    monkeypatch.setattr(port_train, "generate_surrogate_dataset",
                        functools.partial(
                            port_train.generate_surrogate_dataset,
                            num_samples=2500))
    run = str(tmp_path / "run")
    config, device = port_main.parse_args([
        "--input_dir", surrogate_dir, "--output_dir", run, "--model", "mlp",
        "--algorithm", "gan", "--epochs", "1", "--batch_size", "512",
        "--num_units", "8", "--noise_dim", "8", "--ema", "0.9", "--verbose",
        "0", "--device", "cpu"])
    assert config.surrogate_ds and device == "cpu"
    metrics = port_train.main(config, return_metrics=True, device=device)
    assert config.global_step == 16 and config.sequence_length == 6
    assert all(np.isfinite(v) for v in metrics.values())
    generated = _load(os.path.join(run, "generated.pkl"))["signals"]
    assert generated.shape == (3000, 6, 2)  # rounded up to whole batches
    assert generated.dtype == np.float32 and np.isfinite(generated).all()
    assert config.signals_min <= generated.min()
    assert generated.max() <= config.signals_max
    assert os.path.exists(os.path.join(run, "checkpoints", "epoch-000.pt"))


# ---------------------------------------------------------------------------
# generate_dg_data -> generate_tfrecords -> main -> compute_dg_metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dg_records(tmp_path_factory):
    root = tmp_path_factory.mktemp("dg")
    raw = _recording(str(root / "raw" / "rec.pkl"), seed=2)
    data = str(root / "dg" / "data.pkl")
    port_dg.main(["--input", raw, "--output", data, "--seed", "4",
                  "--device", "cpu"])
    records = str(root / "records")
    port_records.cli(["--input", data, "--output_dir", records,
                      "--sequence_length", "32", "--stride", "8",
                      "--normalize", "--is_dg_data", "--validation_size",
                      "12", "--verbose", "0"])
    return records


def _train(records, run):
    port_main.cli(["--input_dir", records, "--output_dir", run,
                   "--batch_size", "8", "--num_units", "2", "--kernel_size",
                   "4", "--noise_dim", "4", "--epochs", "1", "--n_critic",
                   "1", "--m", "2", "--layer_norm", "--save_generated",
                   "last", "--verbose", "0", "--device", "cpu"])


def _flat(results):
    return {f"{a}/{b}": v for a, d in results.items() for b, v in d.items()}


def test_dg_path_matches_the_root_compute_dg_metrics(dg_records, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)  # --save_plots writes under ./diagrams
    info = pipeline.load_info(dg_records)
    assert info["num_neurons"] == NEURONS - 2  # --is_dg_data drops no row
    assert info["validation_size"] == 12
    run = str(tmp_path / "run")
    _train(dg_records, run)
    fake = io.load_generated_info(Config(output_dir=run))[0]["filename"]
    assert fake.endswith(".h5") and not h5.contains(fake, "spikes")

    # the root CLI deconvolves with the JAX package's OASIS and evaluates
    theirs = root_metrics.main(JaxConfig(output_dir=run))
    assert h5.get_shape(fake, "spikes") == (12, 32, NEURONS - 2)
    h5.delete(fake, "spikes")  # the port deconvolves for itself

    config, device = port_metrics.parse_args(
        ["--output_dir", run, "--device", "cpu", "--save_plots", "--format",
         "png"])
    seconds = {}
    ours = port_metrics.main(config, device=device, seconds=seconds)
    assert config.num_trials == 5 and config.num_samples == 12
    assert seconds["traces"] == 12 * (NEURONS - 2)
    assert h5.get_shape(fake, "spikes") == (12, 32, NEURONS - 2)
    assert {k: set(v) for k, v in ours.items()} == {
        "firing_rate": {"mae", "rmse", "mape"},
        "covariance": {"mae", "mse", "mape"}}
    for key, value in _flat(ours).items():
        assert np.isfinite(value), key
        np.testing.assert_allclose(value, _flat(theirs)[key], rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert ours["firing_rate"]["mae"] > 0
    assert sorted(os.listdir(tmp_path / "diagrams")) == [
        "dg_covariance.png", "dg_firing_rate.png"]

    # the statistics as the root CLI computes them, array by array
    for name in (config.validation_cache, fake):
        for a, b in zip(port_metrics.get_data_statistics(config, name),
                        root_metrics.get_data_statistics(config, name)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    # planted fault: statistics of all 12 trials instead of --num_trials
    config.num_trials = 12
    wrong = port_metrics.main(config, device="cpu")
    assert any(abs(v - _flat(theirs)[k]) > 1e-4 * abs(_flat(theirs)[k])
               for k, v in _flat(wrong).items())

    # the same run with .npys files gives the same dictionary, and no
    # figure where matplotlib is missing
    monkeypatch.setattr(h5, "have_h5py", lambda: False)
    run_npys = str(tmp_path / "run_npys")
    _train(dg_records, run_npys)
    monkeypatch.setattr(port_metrics.importlib.util, "find_spec",
                        lambda name: None)
    config, device = port_metrics.parse_args(
        ["--output_dir", run_npys, "--device", "cpu", "--save_plots"])
    again = port_metrics.main(config, device=device)
    assert config.validation_cache.endswith(".npys")
    assert not os.path.exists(tmp_path / "diagrams" / "dg_firing_rate.pdf")
    for key, value in _flat(again).items():
        np.testing.assert_allclose(value, _flat(ours)[key], rtol=1e-5,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("y_true,y_pred", [
    ([[1.0, 0.0], [2.0, 4.0], [0.0, 0.5]], [[0.5, 0.25], [2.0, 3.0],
                                            [1.0, 0.5]]),
    ([[0.2, 0.4, 0.6]], [[0.1, 0.4, 0.9]])])
def test_percentage_errors_equal_the_root_clis(y_true, y_pred):
    y_true, y_pred = np.array(y_true), np.array(y_pred)
    np.testing.assert_array_equal(
        port_metrics.percentage_error(y_true, y_pred),
        root_metrics.percentage_error(y_true, y_pred))
    assert port_metrics.mean_absolute_percentage_error(y_true, y_pred) == \
        root_metrics.mean_absolute_percentage_error(y_true, y_pred)


# ---------------------------------------------------------------------------
# devices, get_coordinate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["generate_dg_data",
                                   "generate_surrogate_data",
                                   "compute_dg_metrics", "main_mlp"])
def test_cuda_without_a_card_raises(entry, tmp_path, surrogate_dir):
    assert not torch.cuda.is_available()  # this host has no card
    calls = {
        "generate_dg_data": lambda: port_dg.main(
            ["--input", _recording(str(tmp_path / "r" / "rec.pkl")),
             "--output", str(tmp_path / "x.pkl")]),
        "generate_surrogate_data": lambda: port_sur.main(
            ["--output_dir", str(tmp_path / "s"), "--num_samples", "10"]),
        "compute_dg_metrics": lambda: port_metrics.cli(
            ["--output_dir", str(tmp_path)]),
        "main_mlp": lambda: port_main.cli(
            ["--input_dir", surrogate_dir, "--output_dir",
             str(tmp_path / "run"), "--model", "mlp"])}
    # the default device is cuda
    assert port_dg.parse_args([]).device == "cuda"
    assert port_sur.parse_args([]).device == "cuda"
    assert port_metrics.parse_args([])[1] == "cuda"
    assert port_main.parse_args([])[1] == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not os.path.exists(tmp_path / "x.pkl")


def test_get_coordinate_equals_the_root_cli(tmp_path, capsys):
    import h5py
    filename = str(tmp_path / "rec.mat")
    rng = np.random.default_rng(0)
    with h5py.File(filename, "w") as f:
        refs = f.create_dataset("data", (5, 1), dtype=h5py.ref_dtype)
        for i in range(5):
            group = f.create_group(f"roi{i}")
            group["mnCoordinates"] = rng.integers(0, 512, (3 + i, 2))
            refs[i, 0] = group.ref
    out = str(tmp_path / "coords.pkl")
    ours = port_coordinate.cli(["--filename", filename, "--out", out])
    theirs = root_coordinate.main(argparse.Namespace(filename=filename,
                                                     out=""))
    assert len(ours) == len(theirs) == 3  # the first two ROIs are skipped
    for a, b, saved in zip(ours, theirs, _load(out)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, saved)
    assert "ROI 002: 5 points" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not exists"):
        port_coordinate.cli(["--filename", str(tmp_path / "none.mat")])
