"""The port's ``DevicePrefetcher`` (``calciumgan_tpu_torch.data.pipeline``)
against the JAX package's (``calciumgan_tpu/data/pipeline.py:328-374``)
and the main-thread path it stands in for:

- its batches are ``HostBatches``' bit for bit, in order, and the JAX
  prefetcher's over the same rows, as many as JAX's test counts
  (``tests/test_data.py:230-246``);
- an error in the worker reaches the consumer after the batch before it
  (``tests/test_data.py:264-276``);
- ``python -m calciumgan_tpu_torch.main`` with ``--device_store off`` (the
  epochs stream through the prefetcher) and ``--device_store on`` gives
  bit-equal epoch losses and generated signals, as JAX's
  ``test_device_store_matches_streaming`` requires of the JAX package
  (``tests/test_train.py:98-130``);
- its thread is gone when the epoch ends.

On the CPU the worker gathers on the host and uses no stream; the card's
side-stream copy is checked by ``chip_smoke.py`` (phase 6).
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from calciumgan_tpu.data import pipeline as jax_pipeline
from calciumgan_tpu.data import segments
from calciumgan_tpu.utils.tb_reader import read_scalars
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch import train
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data import pipeline
from calciumgan_tpu_torch.utils import h5
from test_data import make_dataset_dir

torch.set_num_threads(1)


def _alive():
    return [t for t in threading.enumerate()
            if t.name == "DevicePrefetcher" and t.is_alive()]


def test_prefetched_batches_equal_host_batches_and_jax(tmp_path, rng):
    out, _, _ = make_dataset_dir(tmp_path, rng)
    cfg = Config(input_dir=out, batch_size=8)
    train_ds, _ = pipeline.get_datasets(cfg)
    source = pipeline.HostBatches(train_ds.signals, "cpu")
    order = np.random.default_rng(3).permutation(len(train_ds))
    batches = [order[i * 8:(i + 1) * 8] for i in range(len(train_ds) // 8)]
    got = list(pipeline.DevicePrefetcher(source, batches))
    assert len(got) == len(train_ds) // 8 == len(batches) > 2
    for batch, idx in zip(got, batches):
        assert batch.shape == (8, 32, 4) and batch.dtype == torch.float32
        assert batch.numpy().tobytes() == source.batch(idx).numpy().tobytes()
    # the JAX prefetcher over the same rows, staged as numpy arrays
    theirs = list(jax_pipeline.DevicePrefetcher(
        (train_ds.signals[idx] for idx in batches), np.asarray))
    assert [b.numpy().tobytes() for b in got] == [
        np.asarray(t, np.float32).tobytes() for t in theirs]
    assert not _alive()


def test_prefetcher_propagates_worker_errors():
    source = pipeline.HostBatches(np.zeros((4, 2, 3), np.float32), "cpu")

    def bad_batches():
        yield np.array([0, 1])
        raise RuntimeError("boom in worker")

    pf = pipeline.DevicePrefetcher(source, bad_batches())
    assert next(pf).shape == (2, 2, 3)
    with pytest.raises(RuntimeError, match="boom in worker"):
        next(pf)
    with pytest.raises(StopIteration):  # then the sentinel
        next(pf)
    assert not _alive()


def test_prefetcher_keeps_order_under_thread_switches():
    """Many small batches with the interpreter switching threads as often
    as it can: each arrives once, in order."""
    source = pipeline.HostBatches(
        np.arange(400, dtype=np.float32).reshape(400, 1, 1), "cpu")
    batches = [np.array([i]) for i in range(400)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = [float(b) for b in pipeline.DevicePrefetcher(source, batches)]
    finally:
        sys.setswitchinterval(interval)
    assert got == [float(i) for i in range(400)]
    assert not _alive()


def test_a_bad_index_reaches_the_consumer():
    source = pipeline.HostBatches(np.zeros((4, 2, 3), np.float32), "cpu")
    pf = pipeline.DevicePrefetcher(source, [np.array([0]), np.array([9])])
    next(pf)
    with pytest.raises(IndexError):
        next(pf)


@pytest.fixture(scope="module")
def store_runs(tmp_path_factory):
    """JAX's ``test_device_store_matches_streaming`` dataset and flags, run
    by the port with ``--device_store off`` and ``on``; the batch sources
    each built and the prefetchers each started."""
    root = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(0)
    data = {"signals": rng.random((4, 800)).astype(np.float32),
            "oasis": (rng.random((4, 800)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, do_normalize=True, is_dg_data=True)
    input_dir = str(root / "records")
    # validation_size 12 with batch 8 -> a ragged 4-row tail batch
    segments.write_dataset(input_dir, signals, spikes, meta, 32, 8,
                           validation_size=12, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    runs = {}
    for mode in ("off", "on"):
        sources, prefetchers = [], []
        make_sources, make_prefetcher = (train.make_batch_sources,
                                         pipeline.DevicePrefetcher)

        def sources_of(*args, **kw):
            sources.append(make_sources(*args, **kw))
            return sources[-1]

        def prefetcher(*args, **kw):
            prefetchers.append(make_prefetcher(*args, **kw))
            return prefetchers[-1]

        run = str(root / f"run_{mode}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train, "make_batch_sources", sources_of)
            mp.setattr(pipeline, "DevicePrefetcher", prefetcher)
            port_main.cli([
                "--input_dir", input_dir, "--output_dir", run,
                "--batch_size", "8", "--num_units", "2", "--kernel_size",
                "4", "--noise_dim", "4", "--epochs", "2", "--n_critic", "2",
                "--model", "calciumgan", "--algorithm", "wgan-gp",
                "--save_generated", "all", "--skip_checkpoints",
                "--device_store", mode, "--verbose", "0", "--device",
                "cpu"])
        runs[mode] = dict(run=run, sources=sources, prefetchers=prefetchers)
    return runs


def test_device_store_matches_streaming(store_runs):
    off, on = store_runs["off"], store_runs["on"]
    assert all(isinstance(s, pipeline.HostBatches)
               for s in off["sources"][0])
    assert all(isinstance(s, pipeline.DeviceStore) for s in on["sources"][0])
    # one prefetcher a training epoch, none where the signals are stored
    assert len(off["prefetchers"]) == 2 and not on["prefetchers"]
    fakes = {mode: h5.get(os.path.join(
        store_runs[mode]["run"], "generated",
        f"epoch001_signals{h5.default_suffix(False)}"), "signals")
        for mode in ("off", "on")}
    assert fakes["on"].shape == (12, 32, 4)
    assert fakes["on"].tobytes() == fakes["off"].tobytes()
    for sub in ("", "validation"):
        logs = {mode: read_scalars(os.path.join(store_runs[mode]["run"],
                                                sub))
                for mode in ("off", "on")}
        losses = sorted(t for t in logs["on"] if t.startswith("loss/"))
        assert len(losses) >= 2
        for tag in losses:
            assert logs["off"][tag] == logs["on"][tag], (sub, tag)


def test_prefetcher_thread_is_gone_after_the_epoch(store_runs):
    threads = [pf._thread for pf in store_runs["off"]["prefetchers"]]
    assert threads and not any(t.is_alive() for t in threads)
    assert not _alive()
