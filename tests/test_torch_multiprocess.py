"""Data-parallel training of the port in 2 gloo ranks on the host: the
counterpart of ``tests/test_multihost.py`` (2 ``jax.distributed``
processes), at its size (4 recordings of 800 frames in windows of 32,
batch 8, units 2, kernel 4, 2 epochs).

- ``python -m calciumgan_tpu_torch.main --data_parallelism 2 --device cpu
  --save_generated all`` starts two ranks: one writer of ``hparams.json``,
  the checkpoints, the event files, ``info.pkl`` (naming rank 0's shard)
  and the validation cache; ``epochNNN_signals.h5.000`` and ``.001``
  whose rows together are the validation set; each rank's records those
  the JAX package's reader gives its ``(process_index, process_count)``,
  under its own cache name;
- a 2-rank run's checkpoint resumes a one-process run, and a one-process
  run's a 2-rank run;
- ``--surrogate_ds`` (the mlp on a surrogate set) writes
  ``generated.pkl.000`` and ``.001``, a half of each batch each;
- ``generate.main`` in 2 ranks writes ``samples.h5.000`` and ``.001``
  whose rows, put back together batch by batch, are the one-process rows;
- the sweep gives a worker of 2 GPUs an experiment through the launcher,
  over NCCL, on both (the launcher spied on: this host has no card).

The rank work after the CLI's run is one launch of two ranks
(``torch_rank_helpers.rank_jobs``); every launch has a timeout.
"""

import glob
import json
import os
import pickle
import shutil
import threading

import numpy as np
import pytest
import torch

from calciumgan_tpu.data import pipeline as jax_pipeline
from calciumgan_tpu.data import segments
from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch import search
from calciumgan_tpu_torch import train as port_train
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data import pipeline
from calciumgan_tpu_torch.parallel import launch as launch_lib
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import checkpoint, h5
import torch_rank_helpers as ranks
from test_torch_search import TINY_GRID, sweep_args

torch.set_num_threads(1)

TIMEOUT = 300  # seconds a launch may take before its ranks are killed
STEPS = 10     # an epoch's steps: 81 windows, 40 a rank, 4 rows a step


def flags(records, run, epochs, *extra):
    return ["--input_dir", records, "--output_dir", run, "--batch_size",
            "8", "--num_units", "2", "--kernel_size", "4", "--noise_dim",
            "4", "--epochs", str(epochs), "--n_critic", "2", "--model",
            "calciumgan", "--algorithm", "wgan-gp", "--checkpoint_every",
            "1", "--verbose", "0", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``tests/test_multihost.py``'s dataset: 81 + 16 windows of 32 x 4."""
    rng = np.random.default_rng(1234)
    data = {"signals": rng.random((4, 800)).astype(np.float32),
            "oasis": (rng.random((4, 800)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, do_normalize=True, is_dg_data=True)
    out = str(tmp_path_factory.mktemp("data") / "records")
    segments.write_dataset(out, signals, spikes, meta, 32, 8,
                           validation_size=16, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    return out


@pytest.fixture(scope="module")
def surrogate(tmp_path_factory):
    """A surrogate set: 8192 training and 64 validation trials of 2
    neurons x 6 frames."""
    out = tmp_path_factory.mktemp("data") / "surrogate"
    out.mkdir()
    rng = np.random.default_rng(5)
    with open(out / "training.pkl", "wb") as f:
        pickle.dump({"signals": rng.random((8256, 2, 6)).astype(np.float32),
                     "spikes": (rng.random((8256, 6, 2)) < 0.2).astype(
                         np.float32)}, f)
    return str(out)


@pytest.fixture(scope="module")
def two_rank_run(records, tmp_path_factory):
    """The CLI's 2-rank run, 2 epochs, ``--save_generated all``."""
    run = str(tmp_path_factory.mktemp("runs") / "run")
    with pytest.MonkeyPatch.context() as mp:
        launch = launch_lib.launch
        mp.setattr(launch_lib, "launch", lambda *a, **k: launch(
            *a, **dict(k, timeout=TIMEOUT)))
        port_main.cli(flags(records, run, 2, "--data_parallelism", "2",
                            "--save_generated", "all"))
    return run


@pytest.fixture(scope="module")
def rank_work(two_rank_run, records, surrogate, tmp_path_factory):
    """In one launch of 2 ranks: the surrogate run, the resume of a
    one-process run, generation from the 2-rank run's checkpoint."""
    root = tmp_path_factory.mktemp("ranks")
    resumed = str(root / "resumed")
    config, _ = port_main.parse_args(flags(records, resumed, 1))
    port_train.main(config, device="cpu")  # one process, epoch 0
    layout = mesh_lib.create_mesh(2, devices=["cpu", "cpu"])
    config_2, _ = port_main.parse_args(flags(records, resumed, 2,
                                             "--data_parallelism", "2"))
    sur = str(root / "surrogate_run")
    sur_config, _ = port_main.parse_args([
        "--input_dir", surrogate, "--output_dir", sur, "--model", "mlp",
        "--algorithm", "gan", "--epochs", "1", "--batch_size", "512",
        "--num_units", "8", "--noise_dim", "8", "--verbose", "0",
        "--data_parallelism", "2", "--save_generated", "last", "--device",
        "cpu"])
    samples = str(root / "samples.h5")
    jobs = [("resume", ranks.rank_train, (config_2, layout)),
            ("surrogate", ranks.rank_train, (sur_config, layout, 2500)),
            ("generate", ranks.rank_generate, (
                Config(output_dir=two_rank_run, verbose=0), 10, samples,
                4))]
    results = launch_lib.launch(ranks.rank_jobs, ["cpu", "cpu"], "gloo",
                                args=(jobs,), timeout=TIMEOUT)
    return dict(results=results, resumed=resumed, surrogate=sur,
                samples=samples, surrogate_config=sur_config)


def _latest(run):
    with open(os.path.join(run, "checkpoints", "latest.json")) as f:
        return json.load(f)


def test_two_ranks_write_through_one_writer(two_rank_run):
    run = two_rank_run
    assert os.path.exists(os.path.join(run, "hparams.json"))
    assert not glob.glob(os.path.join(run, "**", "*.tmp"), recursive=True)
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == [
        "epoch-000.pt", "epoch-001.pt", "latest.json"]
    assert _latest(run) == {"epoch": 1, "global_step": 2 * STEPS}
    assert len(glob.glob(os.path.join(run, "events.out.tfevents.*"))) == 1
    assert len(glob.glob(os.path.join(run, "validation",
                                      "events.out.tfevents.*"))) == 1
    generated = os.path.join(run, "generated")
    assert os.path.exists(os.path.join(generated, "validation.h5"))
    with open(os.path.join(generated, "info.pkl"), "rb") as f:
        info = pickle.load(f)
    assert set(info) == {0, 1}
    assert info[1]["filename"].endswith("epoch001_signals.h5.000")
    assert info[1]["global_step"] == 2 * STEPS
    for epoch in (0, 1):
        shards = sorted(glob.glob(os.path.join(
            generated, f"epoch{epoch:03d}_signals.h5.*")))
        assert [s.rsplit(".", 1)[1] for s in shards] == ["000", "001"]
        rows = [h5.get_dataset_length(s, "signals") for s in shards]
        assert rows == [8, 8] and sum(rows) == 16  # the validation set
        assert np.isfinite(h5.get(shards[0], "signals")).all()


@pytest.mark.parametrize("split", ["train", "validation"])
def test_each_rank_reads_the_records_jax_gives_its_process(
        two_rank_run, records, tmp_path, split):
    cfg = Config(input_dir=records)
    pipeline.apply_dataset_info(cfg, pipeline.load_info(records))
    assert os.path.exists(os.path.join(
        records, f".{split}.cache-001-of-002.signals.npy"))
    fresh = str(tmp_path / "fresh")  # no cache: both readers decode
    shutil.copytree(records, fresh, ignore=shutil.ignore_patterns(".*"))
    pattern = os.path.join(fresh, f"{split}-*.record")
    sizes = []
    for rank in range(2):
        ours = pipeline._read_shards(pattern, cfg.signal_shape,
                                     cfg.spike_shape, rank, 2)
        theirs = jax_pipeline._read_shards(pattern, cfg.signal_shape,
                                           cfg.spike_shape, rank, 2)
        np.testing.assert_array_equal(np.asarray(ours.signals),
                                      np.asarray(theirs.signals))
        np.testing.assert_array_equal(np.asarray(ours.spikes),
                                      np.asarray(theirs.spikes))
        sizes.append(len(ours))
    assert sum(sizes) == getattr(cfg, f"{split}_size")
    # 16 validation records: a 17th rank gets none, as JAX's reader says
    with pytest.raises(ValueError, match="process 16/17 received no "
                                         "records"):
        pipeline._read_shards(os.path.join(fresh, "validation-*.record"),
                              cfg.signal_shape, cfg.spike_shape, 16, 17)


def test_two_rank_checkpoint_resumes_one_process(two_rank_run, records,
                                                 tmp_path):
    run = str(tmp_path / "run")
    shutil.copytree(two_rank_run, run)
    config, _ = port_main.parse_args(flags(records, run, 3))
    port_train.main(config, device="cpu")
    assert config.start_epoch == 2
    assert _latest(run) == {"epoch": 2, "global_step": 3 * STEPS}


def test_one_process_checkpoint_resumes_two_ranks(rank_work):
    assert _latest(rank_work["resumed"]) == {"epoch": 1,
                                             "global_step": 2 * STEPS}
    assert sorted(os.listdir(os.path.join(rank_work["resumed"],
                                          "checkpoints"))) == [
        "epoch-000.pt", "epoch-001.pt", "latest.json"]


def test_surrogate_set_is_written_in_rank_shards(rank_work):
    run = rank_work["surrogate"]
    assert not os.path.exists(os.path.join(run, "generated.pkl"))
    for rank in range(2):
        with open(os.path.join(run, f"generated.pkl.{rank:03d}"), "rb") as f:
            rows = pickle.load(f)["signals"]
        # 2500 samples in batches of 1000: 3000 rows, 1500 a rank
        assert rows.shape == (1500, 6, 2) and np.isfinite(rows).all()
    generated = os.path.join(run, "generated")
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        generated, "epoch000_signals.h5.*"))) == [
        "epoch000_signals.h5.000", "epoch000_signals.h5.001"]
    # 64 validation trials, 32 a rank, in one masked batch of 256 rows
    assert [h5.get_dataset_length(os.path.join(
        generated, f"epoch000_signals.h5.{r:03d}"), "signals")
        for r in range(2)] == [32, 32]


def test_generate_shards_put_together_equal_one_process(rank_work,
                                                        two_rank_run):
    shards = [h5.get(f"{rank_work['samples']}.{r:03d}", "signals")
              for r in range(2)]
    assert [len(s) for s in shards] == [6, 4]  # 10 rows, batches of 4
    config = Config(output_dir=two_rank_run, verbose=0).load()
    variables, _ = checkpoint.restore_generator_params(
        os.path.join(two_rank_run, "checkpoints"), ema=False)
    one = np.concatenate([p["signals"] for p in generate_mod.generate(
        config, variables, 10, 4, device="cpu")])
    together = np.concatenate([shards[0][0:2], shards[1][0:2],
                               shards[0][2:4], shards[1][2:4],
                               shards[0][4:6]])
    np.testing.assert_allclose(together, one, rtol=0, atol=1e-6)


def test_sweep_worker_of_two_gpus_trains_through_the_launcher(
        tmp_path, records, monkeypatch):
    monkeypatch.setattr(search.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(search.torch.cuda, "is_available", lambda: True)
    slices = search.device_slices("cuda", 2)
    assert slices == [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]
    calls = []

    def spy(fn, devices, backend, args=(), **kw):
        calls.append((fn, tuple(devices), backend, args))
        return [{"signals_metrics/mean": 0.5}] * len(devices)

    monkeypatch.setattr(launch_lib, "launch", spy)
    args = sweep_args(records, str(tmp_path / "sweep"), parallel=2)
    params = dict(zip(TINY_GRID, (v[0] for v in TINY_GRID.values())))
    search._run_one(args, os.path.join(args.output_dir, "results.jsonl"),
                    threading.Lock(), 1, params, device="cuda:0",
                    devices=slices[0])
    (fn, devices, backend, (config, metrics, _, layout)), = calls
    assert fn is port_train.main and backend == "nccl"
    assert devices == layout.devices == ("cuda:0", "cuda:1")
    assert metrics and config.model == "mlp"
    with open(os.path.join(args.output_dir, "results.jsonl")) as f:
        line = json.loads(f.read())
    assert line["session"] == 1 and line["metrics"] == {
        "signals_metrics/mean": 0.5}
