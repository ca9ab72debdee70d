"""The port's dataset preparation (``data/segments.py`` and the
``generate_tfrecords`` CLI) against the JAX package's: the same arrays, the
same bytes on disk, the same ``info.pkl``. Everything here is exact: the
copies do the same numpy operations in the same order.
"""

import argparse
import glob
import os
import pickle

import numpy as np
import pytest
import torch

from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.data import pipeline as jax_pipeline
from calciumgan_tpu.data import segments as jax_segments
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data import pipeline, segments
from calciumgan_tpu_torch.dataset import generate_tfrecords as port_cli
from dataset import generate_tfrecords as jax_cli

torch.set_num_threads(1)

MODES = {
    "plain": dict(do_normalize=True),
    "raw": dict(),
    "fft_global": dict(apply_fft=True, do_normalize=True),
    "fft_per_channel": dict(apply_fft=True, do_normalize=True,
                            fft_norm="per_channel"),
    "conv2d": dict(conv2d=True, do_normalize=True),
    "fft_conv2d": dict(apply_fft=True, conv2d=True, do_normalize=True,
                       fft_norm="per_channel"),
    "dg": dict(do_normalize=True, is_dg_data=True),
}


def recording(seed=0, neurons=8, T=700):
    rng = np.random.default_rng(seed)
    return {"signals": rng.standard_normal((neurons, T)).astype(np.float32)
            .cumsum(axis=1).astype(np.float32),
            "oasis": (rng.random((neurons, T)) < 0.05).astype(np.float32)}


def equal_meta(ours, theirs):
    assert list(ours) == list(theirs)
    for key in ours:
        if isinstance(theirs[key], np.ndarray):
            assert ours[key].dtype == theirs[key].dtype
            np.testing.assert_array_equal(ours[key], theirs[key])
        else:
            assert type(ours[key]) is type(theirs[key])
            assert ours[key] == theirs[key], key


@pytest.mark.parametrize("mode", sorted(MODES))
def test_preprocess_equals_jax_exactly(mode):
    data = recording()
    ours = segments.preprocess(data, 64, 12, **MODES[mode])
    theirs = jax_segments.preprocess(data, 64, 12, **MODES[mode])
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    equal_meta(ours[2], theirs[2])
    signals, spikes, meta = ours
    C = 8 if mode == "dg" else 6  # recorded data drops its first 2 rows
    assert meta["num_neurons"] == C and len(signals) == 53
    assert spikes.shape == (53, 64, C)
    if mode == "plain":  # a window is the recording's, normalised
        raw = data["signals"][2:].T[3 * 12:3 * 12 + 64]
        lo, hi = meta["signals_min"], meta["signals_max"]
        np.testing.assert_allclose(signals[3] * (hi - lo) + lo, raw,
                                   atol=1e-4)
        np.testing.assert_array_equal(spikes[3],
                                      data["oasis"][2:].T[36:100])
        assert signals.min() == 0.0 and signals.max() == 1.0


def test_helpers_equal_jax():
    for length, n in ((10, 3), (7, 7), (5, 1), (0, 2)):
        assert segments.split_index(length, n) == \
            jax_segments.split_index(length, n)
    assert segments.split(list(range(10)), 3) == \
        jax_segments.split(list(range(10)), 3)
    for T, sl, stride in ((700, 64, 12), (64, 64, 1), (65, 64, 1),
                          (20000, 2048, 28)):
        np.testing.assert_array_equal(
            segments.window_starts(T, sl, stride),
            jax_segments.window_starts(T, sl, stride))
    assert len(segments.window_starts(20000, 2048, 28)) == 642
    for sl, fft, size in ((2048, False, 0.5), (120, True, 0.5),
                          (2048, False, 0.0)):
        assert segments.num_per_shard(sl, fft, size) == \
            jax_segments.num_per_shard(sl, fft, size)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 33, 5)).astype(np.float32)
    np.testing.assert_array_equal(segments.fft_signals(x),
                                  jax_segments.fft_signals(x))
    np.testing.assert_array_equal(
        segments.ifft_signals(segments.fft_signals(x)),
        jax_segments.ifft_signals(jax_segments.fft_signals(x)))
    np.testing.assert_array_equal(
        segments.normalize(x, x.min(0), x.max(0)),
        jax_segments.normalize(x, x.min(0), x.max(0)))
    raw = rng.standard_normal((200, 4)).astype(np.float32)
    for a, b in zip(segments.segment_recording(raw, raw > 1, 32, 5),
                    jax_segments.segment_recording(raw, raw > 1, 32, 5)):
        np.testing.assert_array_equal(a, b)
    for module in (segments, jax_segments):
        with pytest.raises(ValueError, match="unknown fft_norm"):
            module.preprocess(recording(), 64, 12, fft_norm="x")
        with pytest.raises(ValueError, match="requires --fft --normalize"):
            module.preprocess(recording(), 64, 12, fft_norm="per_channel")


def record_bytes(directory):
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.record"))):
        with open(path, "rb") as f:
            out[os.path.basename(path)] = f.read()
    return out


def load_info(directory):
    with open(os.path.join(directory, "info.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("mode", ["plain", "fft_per_channel", "conv2d"])
def test_write_dataset_is_byte_equal_to_jax(tmp_path, mode):
    kw = MODES[mode]
    signals, spikes, meta = jax_segments.preprocess(recording(), 64, 12, **kw)
    flags = dict(sequence_length=64, stride=12, validation_size=10,
                 do_normalize=True, apply_fft=kw.get("apply_fft", False),
                 conv2d=kw.get("conv2d", False),
                 # about 18 segments per shard: several shards
                 target_shard_size=0.00087, verbose=0,
                 fft_norm=kw.get("fft_norm", "global"))
    ours_dir, theirs_dir = str(tmp_path / "ours"), str(tmp_path / "theirs")
    ours = segments.write_dataset(ours_dir, signals, spikes, meta, **flags)
    theirs = jax_segments.write_dataset(theirs_dir, signals, spikes, meta,
                                        **flags)
    ours_files, theirs_files = record_bytes(ours_dir), record_bytes(theirs_dir)
    assert list(ours_files) == list(theirs_files)
    assert len(ours_files) > 2
    assert ours_files == theirs_files  # byte for byte
    equal_meta(ours, theirs)
    equal_meta(load_info(ours_dir), load_info(theirs_dir))
    assert ours["train_size"] == 43 and ours["validation_size"] == 10
    # another seed shuffles other rows into the shards
    other = str(tmp_path / "other")
    segments.write_dataset(other, signals, spikes, meta, seed=1, **flags)
    assert record_bytes(other) != theirs_files
    for module in (segments, jax_segments):
        with pytest.raises(ValueError, match="validation_size 54 must be"):
            module.write_dataset(str(tmp_path / "bad"), signals, spikes, meta,
                                 **dict(flags, validation_size=54))


def test_generate_tfrecords_cli_equals_the_root_cli(tmp_path, capsys):
    pkl = str(tmp_path / "rec.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(recording(seed=2, neurons=10, T=900), f)
    argv = ["--input", pkl, "--sequence_length", "64", "--stride", "8",
            "--normalize", "--validation_size", "16", "--verbose", "0",
            "--target_shard_size", "0.002"]
    ours_dir, theirs_dir = str(tmp_path / "ours"), str(tmp_path / "theirs")
    port_cli.cli(argv + ["--output_dir", ours_dir])
    args = port_cli.parse_args(argv + ["--output_dir", theirs_dir])
    # the same flags and defaults as the root CLI's parser
    assert vars(args) | {"output_dir": ""} == dict(
        input=pkl, output_dir="", sequence_length=64, stride=8,
        normalize=True, fft=False, fft_norm="global", conv2d=False,
        replace=False, validation_size=16, is_dg_data=False,
        target_shard_size=0.002, verbose=0)
    jax_cli.main(args)
    assert "saved 89 train + 16 validation segments" in \
        capsys.readouterr().out
    assert record_bytes(ours_dir) == record_bytes(theirs_dir)
    equal_meta(load_info(ours_dir), load_info(theirs_dir))
    # read back by both pipelines
    ours_cfg = Config(input_dir=ours_dir, batch_size=8)
    theirs_cfg = JaxConfig(input_dir=ours_dir, batch_size=8)
    for a, b in zip(pipeline.get_datasets(ours_cfg),
                    jax_pipeline.get_datasets(theirs_cfg)):
        np.testing.assert_array_equal(np.asarray(a.signals),
                                      np.asarray(b.signals))
        np.testing.assert_array_equal(np.asarray(a.spikes),
                                      np.asarray(b.spikes))
    assert ours_cfg.train_size == 89 and ours_cfg.signal_shape == (64, 8)
    # an existing directory needs --replace; a missing input exits
    with pytest.raises(SystemExit):
        port_cli.cli(argv + ["--output_dir", ours_dir])
    port_cli.cli(argv + ["--output_dir", ours_dir, "--replace"])
    assert record_bytes(ours_dir) == record_bytes(theirs_dir)
    with pytest.raises(SystemExit):
        port_cli.main(argparse.Namespace(input=str(tmp_path / "none.pkl"),
                                         output_dir=ours_dir))
