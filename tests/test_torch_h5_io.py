"""The port's dataset files (``utils/h5.py``, both containers), its
``utils/io.py`` and ``utils/arrays.py`` against the JAX package's modules.

Every function of ``h5`` runs the same calls on three files: the JAX
package's h5, the port's h5 and the port's ``.npys`` directory of ``.npy``
arrays; what they read back is equal, dtype included. ``.h5`` files cross
between the packages both ways. The container follows the file's name only:
a ``.h5`` name without ``h5py`` raises ``ImportError``.
"""

import builtins
import os

import numpy as np
import pytest
import torch

from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from calciumgan_tpu.utils import arrays as jax_arrays
from calciumgan_tpu.utils import h5 as jax_h5
from calciumgan_tpu.utils import io as jax_io
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data.pipeline import ArrayDataset
from calciumgan_tpu_torch.utils import arrays, h5, io

torch.set_num_threads(1)

CONTAINERS = [(jax_h5, "jax.h5"), (h5, "port.h5"), (h5, "port.npys")]


def content(seed, rows):
    rng = np.random.default_rng(seed)
    return {"signals": rng.standard_normal((rows, 16, 3)).astype(np.float32),
            "spikes": (rng.random((rows, 16, 3)) < 0.2).astype(np.int8)}


@pytest.fixture
def files(tmp_path):
    """The same two writes (the second appends) through each container."""
    out = []
    for module, name in CONTAINERS:
        path = str(tmp_path / name)
        module.write(path, content(0, 5))
        module.write(path, content(1, 3))
        out.append((module, path))
    return out


def same(results):
    first = results[0]
    for other in results[1:]:
        assert type(other) is type(first)
        if isinstance(first, np.ndarray):
            assert other.dtype == first.dtype and other.shape == first.shape
            np.testing.assert_array_equal(other, first)
        else:
            assert other == first
    return first


def test_write_appends_and_get_slices(files):
    full = np.concatenate([content(0, 5)["signals"], content(1, 3)["signals"]])
    np.testing.assert_array_equal(
        same([m.get(p, "signals") for m, p in files]), full)
    assert same([m.get(p, "spikes") for m, p in files]).dtype == np.int8
    np.testing.assert_array_equal(
        same([m.get(p, "signals", neuron=2) for m, p in files]),
        full[:, :, 2])
    for trial in (0, 6, -1):
        np.testing.assert_array_equal(
            same([m.get(p, "signals", trial=trial) for m, p in files]),
            full[trial])
    for start, stop in ((2, 6), (None, 3), (5, None), (6, 100), (8, 9)):
        np.testing.assert_array_equal(
            same([m.get(p, "signals", start=start, stop=stop)
                  for m, p in files]), full[start:stop])
    assert same([m.get_shape(p, "signals") for m, p in files]) == (8, 16, 3)
    assert same([m.get_dataset_length(p, "spikes") for m, p in files]) == 8
    assert same([m.keys(p) for m, p in files]) == ["signals", "spikes"]
    assert same([m.contains(p, "signals") for m, p in files]) is True
    assert same([m.contains(p, "nothing") for m, p in files]) is False
    assert same([m.keys(p + ".absent") for m, p in files]) == []
    for m, p in files:
        with pytest.raises(KeyError, match="no dataset 'nothing'"):
            m.get(p, "nothing")


def test_truncate_rename_delete_overwrite(files):
    for m, p in files:
        m.truncate(p, "signals", 6)
        m.truncate(p, "spikes", 100)  # longer than the dataset: untouched
    assert same([m.get_dataset_length(p, "signals") for m, p in files]) == 6
    assert same([m.get_dataset_length(p, "spikes") for m, p in files]) == 8
    # a truncated dataset grows again from its new end
    for m, p in files:
        m.write(p, {"signals": content(2, 2)["signals"]})
    expected = np.concatenate([content(0, 5)["signals"],
                               content(1, 3)["signals"][:1],
                               content(2, 2)["signals"]])
    np.testing.assert_array_equal(
        same([m.get(p, "signals") for m, p in files]), expected)
    for m, p in files:
        m.rename(p, "signals", "spikes")  # replaces the existing dataset
    assert same([m.keys(p) for m, p in files]) == ["spikes"]
    np.testing.assert_array_equal(
        same([m.get(p, "spikes") for m, p in files]), expected)
    for m, p in files:
        m.overwrite(p, "spikes", np.arange(6, dtype=np.int16).reshape(2, 3))
        with pytest.raises(KeyError):
            m.overwrite(p, "absent", np.zeros(2))
    assert same([m.get(p, "spikes") for m, p in files]).dtype == np.int16
    for m, p in files:
        m.delete(p, "spikes")
        m.delete(p, "spikes")  # absent: no-op
    assert same([m.keys(p) for m, p in files]) == []


def test_empty_dataset_and_h5py_append(tmp_path):
    for module, name in CONTAINERS:
        path = str(tmp_path / name)
        module.write(path, {"spikes": np.zeros((0, 16, 3), np.int8)})
        assert module.get(path, "spikes").shape == (0, 16, 3)
        assert module.get_dataset_length(path, "spikes") == 0
        module.write(path, {"spikes": np.ones((2, 16, 3), np.int8)})
        assert module.get(path, "spikes").sum() == 96
    import h5py
    for module in (jax_h5, h5):  # append on an open dataset
        with h5py.File(str(tmp_path / "port.h5"), "r+") as f:
            module.append(f["spikes"], np.full((1, 16, 3), 2, np.int8))
    assert h5.get(str(tmp_path / "port.h5"), "spikes").shape == (4, 16, 3)


def test_npy_container_is_plain_npy_and_survives_a_torn_append(tmp_path):
    path = str(tmp_path / "epoch.npys")
    h5.write(path, content(3, 4))
    # each dataset is a .npy file that numpy loads as it is
    loaded = np.load(os.path.join(path, "signals.npy"))
    np.testing.assert_array_equal(loaded, content(3, 4)["signals"])
    # a kill after an append's rows and before its header: the dataset
    # still reads at its old length, and the next append lands behind it
    with open(os.path.join(path, "signals.npy"), "ab") as f:
        f.write(b"\x7f" * 100)
    assert h5.get_dataset_length(path, "signals") == 4
    h5.write(path, {"signals": content(4, 2)["signals"]})
    np.testing.assert_array_equal(
        h5.get(path, "signals"),
        np.concatenate([content(3, 4)["signals"], content(4, 2)["signals"]]))
    size = os.path.getsize(os.path.join(path, "signals.npy"))
    assert size == h5._HEADER_BYTES + 6 * 16 * 3 * 4
    with pytest.raises(ValueError, match="cannot append"):
        h5.write(path, {"signals": np.zeros((1, 16, 4), np.float32)})


def test_h5_files_cross_between_the_packages(tmp_path):
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    h5.write(ours, content(5, 4))
    jax_h5.write(theirs, content(5, 4))
    h5.write(theirs, content(6, 2))      # the port appends to JAX's file
    jax_h5.write(ours, content(6, 2))    # and JAX to the port's
    for name in ("signals", "spikes"):
        expected = np.concatenate([content(5, 4)[name], content(6, 2)[name]])
        np.testing.assert_array_equal(jax_h5.get(ours, name), expected)
        np.testing.assert_array_equal(h5.get(theirs, name), expected)
    jax_h5.rename(ours, "spikes", "done")
    assert h5.keys(ours) == ["done", "signals"]


def test_h5_name_without_h5py_raises(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    path = str(tmp_path / "samples.h5")
    for call in (lambda: h5.write(path, content(0, 1)),
                 lambda: h5.get(path, "signals"),
                 lambda: h5.keys(str(tmp_path)),
                 lambda: h5.contains(path, "signals")):
        with pytest.raises(ImportError, match="h5py"):
            call()
    assert not os.path.exists(path)  # nothing was written another way
    # the numpy container needs no h5py
    h5.write(str(tmp_path / "samples.npys"), content(0, 1))
    assert h5.get_dataset_length(str(tmp_path / "samples.npys"),
                                 "signals") == 1


def test_default_suffix_follows_the_installation(monkeypatch, capsys):
    monkeypatch.setattr(h5, "_announced", False)
    assert h5.default_suffix() == ".h5"  # h5py is installed here
    assert "HDF5" in capsys.readouterr().out
    h5.default_suffix()
    assert capsys.readouterr().out == ""  # one line, once
    monkeypatch.setattr(h5, "have_h5py", lambda: False)
    monkeypatch.setattr(h5, "_announced", False)
    assert h5.default_suffix() == ".npys"
    assert "h5py is not installed" in capsys.readouterr().out
    assert h5.staging_name("a/validation.npys") == "a/validation.tmp.npys"
    assert h5.is_npy("a/validation.tmp.npys") and not h5.is_npy("a/x.h5")


# ---- io ---------------------------------------------------------------------

def run_config(cls, tmp_path, name, cache="validation.h5"):
    out = str(tmp_path / name)
    cfg = cls(output_dir=out, batch_size=4, normalize=True, signals_min=-1.5,
              signals_max=2.5, global_step=7, verbose=0)
    cfg.generated_dir = os.path.join(out, "generated")
    os.makedirs(cfg.generated_dir)
    cfg.validation_cache = os.path.join(cfg.generated_dir, cache)
    return cfg


@pytest.mark.parametrize("suffix", [".h5", ".npys"])
def test_save_fake_signals_appends_replaces_and_equals_jax(tmp_path,
                                                           monkeypatch,
                                                           suffix):
    monkeypatch.setattr(h5, "have_h5py", lambda: suffix == ".h5")
    ours = run_config(Config, tmp_path, "ours")
    theirs = run_config(JaxConfig, tmp_path, "theirs")
    rng = np.random.default_rng(9)
    batches = [rng.random((n, 16, 3)).astype(np.float32) for n in (4, 4, 2)]
    for attempt in range(2):  # the second replaces the first: no doubling
        for i, batch in enumerate(batches):
            ours.global_step = theirs.global_step = 7 + attempt
            name = io.save_fake_signals(ours, 3, torch.from_numpy(batch),
                                        append=i > 0)
            jax_name = jax_io.save_fake_signals(theirs, 3, batch,
                                                append=i > 0)
    assert name == os.path.join(ours.generated_dir,
                                "epoch003_signals" + suffix)
    io.save_fake_signals(ours, 4, batches[0], append=False)
    jax_io.save_fake_signals(theirs, 4, batches[0], append=False)
    saved = h5.get(name, "signals")
    assert saved.shape == (10, 16, 3) and saved.dtype == np.float32
    np.testing.assert_array_equal(saved, jax_h5.get(jax_name, "signals"))
    # denormalised: x * (max - min) + min
    np.testing.assert_allclose(saved, np.concatenate(batches) * 4.0 - 1.5,
                               rtol=1e-6)
    info, jax_info = io.load_generated_info(ours), \
        jax_io.load_generated_info(theirs)
    assert sorted(info) == sorted(jax_info) == [3, 4]
    for epoch in (3, 4):
        assert info[epoch]["global_step"] == jax_info[epoch]["global_step"]
        assert os.path.basename(info[epoch]["filename"]) == os.path.basename(
            jax_info[epoch]["filename"]).replace(".h5", suffix)
    assert info[3]["global_step"] == 8
    assert not os.path.exists(os.path.join(ours.generated_dir,
                                           "info.pkl.tmp"))
    with pytest.raises(FileNotFoundError, match="--save_generated"):
        io.load_generated_info(Config(output_dir=str(tmp_path / "none")))


@pytest.mark.parametrize("cache", ["validation.h5", "validation.npys"])
def test_cache_validation_set_stages_and_equals_jax(tmp_path, cache):
    rng = np.random.default_rng(10)
    signals = rng.random((10, 16, 3)).astype(np.float32)
    spikes = (rng.random((10, 16, 3)) < 0.1).astype(np.float32)
    ours = run_config(Config, tmp_path, "ours", cache)
    theirs = run_config(JaxConfig, tmp_path, "theirs")
    # a stale staging file of a killed run is dropped, not appended to
    stale = h5.staging_name(ours.validation_cache)
    h5.write(stale, {"signals": np.zeros((3, 16, 3), np.float32)})
    io.cache_validation_set(ours, ArrayDataset(signals, spikes))
    jax_io.cache_validation_set(theirs, JaxArrayDataset(signals, spikes))
    assert not os.path.exists(stale)
    for name, dtype in (("signals", np.float32), ("spikes", np.int8)):
        got = h5.get(ours.validation_cache, name)
        assert got.dtype == dtype and got.shape == (10, 16, 3)
        np.testing.assert_array_equal(
            got, jax_h5.get(theirs.validation_cache, name))
    # an existing cache is kept as it is
    io.cache_validation_set(ours, ArrayDataset(signals[:2], spikes[:2]))
    assert h5.get_dataset_length(ours.validation_cache, "signals") == 10
    ours.validation_cache = None
    io.cache_validation_set(ours, ArrayDataset(signals, spikes))  # no-op


# ---- arrays -----------------------------------------------------------------

def test_arrays_equal_the_original_errors_included():
    cfg = Config(sequence_length=16, num_neurons=3, validation_size=5)
    x = np.random.default_rng(11).random((5, 16, 3)).astype(np.float32)
    for shape in ((5, 16, 3), (3, 5, 16), (16, 3), (7,)):
        assert arrays.get_array_format(shape, cfg) == \
            jax_arrays.get_array_format(shape, cfg)
    for fmt in ("NWC", "CNW", "NCW", "WCN"):
        np.testing.assert_array_equal(
            arrays.set_array_format(x, fmt, cfg),
            jax_arrays.set_array_format(x, fmt, cfg))
    assert arrays.set_array_format(x, "CNW", cfg).shape == (3, 5, 16)
    y = np.swapaxes(x, 1, 2)  # (5, 3, 16): validation_size x neurons first
    np.testing.assert_array_equal(arrays.swap_neuron_major(cfg, y),
                                  jax_arrays.swap_neuron_major(cfg, y))
    assert arrays.swap_neuron_major(cfg, x) is x
    z = np.array([1.0, np.nan, 3.0])
    np.testing.assert_array_equal(arrays.remove_nan(z),
                                  jax_arrays.remove_nan(z))
    for module in (arrays, jax_arrays):
        with pytest.raises(ValueError, match="sequence_length == "):
            module.get_array_format((5, 16, 16), Config(sequence_length=16,
                                                        num_neurons=16))
        with pytest.raises(ValueError, match="a batch dim equals"):
            module.get_array_format((16, 16, 3), cfg)
        with pytest.raises(AssertionError, match="cannot convert"):
            module.set_array_format(x[0], "NW", cfg)
