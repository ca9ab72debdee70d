"""The port's sweep (``python -m calciumgan_tpu_torch.search``) against the
root ``search.py``, on the CPU.

Mirrors ``tests/test_search.py`` (runs and resumes, survives a failing
experiment, ``--parallel 2`` on host workers, summarize, ``--grid``) on its
tiny dataset (4 recordings of 700 frames, batch 8, one epoch, ``mlp``),
and holds the port to the JAX package: the same ``Config`` fields and
directory names per experiment, the same session order, the HParams
events byte for byte with the clock patched, and ``results.jsonl`` read
across packages. The port's event files are read by the JAX package's
reader.
"""

import argparse
import dataclasses
import glob
import itertools
import json
import os
import threading
import time

import numpy as np
import pytest

# repo root on sys.path: tests/conftest.py bootstraps it for the session
import search as jax_search  # noqa: E402
from calciumgan_tpu.data import segments
from calciumgan_tpu.utils import tb as jax_tb
from calciumgan_tpu.utils.tb_reader import read_scalars
from calciumgan_tpu_torch import config as port_config
from calciumgan_tpu_torch import search
from calciumgan_tpu_torch.utils import tb as port_tb

TINY_GRID = {
    "algorithm": ["wgan-gp"], "model": ["mlp"],
    "activation": ["leakyrelu"], "noise_dim": [4, 8], "num_units": [4],
    "kernel_size": [2], "strides": [1], "phase_shuffle": [0],
    "gradient_penalty": [10.0], "n_critic": [1],
}


@pytest.fixture
def dataset_dir(tmp_path, rng):
    """``tests/test_search.py``'s dataset, written by the JAX package."""
    data = {"signals": rng.random((4, 700)).astype(np.float32),
            "oasis": (rng.random((4, 700)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, do_normalize=True, is_dg_data=True)
    out = str(tmp_path / "records")
    segments.write_dataset(out, signals, spikes, meta, 32, 8,
                           validation_size=8, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    return out


def sweep_args(dataset_dir, output_dir, **kw):
    return argparse.Namespace(**dict(
        input_dir=dataset_dir, output_dir=output_dir, batch_size=8,
        epochs=1, clear_output_dir=False, mixed_precision=False, verbose=0,
        device="cpu", **kw))


def read_results(output_dir):
    with open(os.path.join(output_dir, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_search_runs_and_resumes(tmp_path, dataset_dir, capsys):
    out = str(tmp_path / "sweep")
    argv = ["--input_dir", dataset_dir, "--output_dir", out,
            "--batch_size", "8", "--epochs", "1", "--device", "cpu",
            "--grid", json.dumps(TINY_GRID)]
    search.main(argv)

    lines = read_results(out)
    assert [line["session"] for line in lines] == [1, 2]
    assert all("signals_metrics/min" in line["metrics"] for line in lines)
    assert all(np.isfinite(list(line["metrics"].values())).all()
               for line in lines)
    assert {line["params"]["noise_dim"] for line in lines} == {4, 8}
    # the JAX package's reader takes the test/ scalars at epochs + 1
    for line in lines:
        cfg = search.experiment_config(
            sweep_args(dataset_dir, out), line["session"], line["params"])
        scalars = read_scalars(os.path.join(cfg.output_dir, "test"))
        for key, value in line["metrics"].items():
            assert scalars[f"test/{key}"] == {2: pytest.approx(value)}
    # the _hparams_ events: the sweep's schema and one per experiment
    events = b"".join(open(p, "rb").read() for p in glob.glob(
        os.path.join(out, "**", "events.out.tfevents.*"), recursive=True))
    assert events.count(b"_hparams_/experiment") == 1
    assert events.count(b"_hparams_/session_start_info") == 2
    # the root CLI's summarize reads the port's results
    assert [r["session"] for r in jax_search.summarize(out)] == \
        [r["session"] for r in search.summarize(out)]

    # resume: both experiments skipped, results file unchanged
    capsys.readouterr()
    search.main(argv)
    assert capsys.readouterr().out.count("already exists") == 2
    assert read_results(out) == lines


def test_search_survives_experiment_failure(tmp_path, dataset_dir,
                                            monkeypatch, capsys):
    monkeypatch.setattr(search, "DEFAULT_GRID", dict(
        TINY_GRID, model=["mlp", "bogus-model"], noise_dim=[4]))
    args = sweep_args(dataset_dir, str(tmp_path / "sweep2"))
    search.search(args)   # must not raise
    assert "ERROR" in capsys.readouterr().out
    assert len(read_results(args.output_dir)) == 1  # only the valid model


def test_search_parallel_over_host_workers(tmp_path, dataset_dir,
                                           monkeypatch):
    """Two experiments in two spawned workers, each on its own device
    (the host's, with ``--device cpu``)."""
    monkeypatch.setattr(search, "DEFAULT_GRID", TINY_GRID)
    args = sweep_args(dataset_dir, str(tmp_path / "psweep"), parallel=2)
    search.search(args)
    lines = read_results(args.output_dir)
    assert sorted(line["session"] for line in lines) == [1, 2]
    assert all(np.isfinite(list(line["metrics"].values())).all()
               for line in lines)


def test_device_slices(monkeypatch):
    assert search.device_slices("cpu", 3) == [["cpu"]] * 3
    for count, parallel, expected in (
            (1, 1, [["cuda:0"]]), (2, 2, [["cuda:0"], ["cuda:1"]]),
            (4, 2, [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]])):
        monkeypatch.setattr(search.torch.cuda, "device_count",
                            lambda: count)
        assert search.device_slices("cuda", parallel) == expected
    monkeypatch.setattr(search.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError,
                       match="1 devices not divisible by --parallel 2"):
        search.device_slices("cuda", 2)


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(search.torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "sweep")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.main(["--input_dir", "records", "--output_dir", out])
    assert not os.path.exists(out)


def write_results_line(module, output_dir, session, params, metrics,
                       monkeypatch):
    """One ``results.jsonl`` line written by ``module._run_one`` (the JAX
    package's or the port's) around an experiment that returns
    ``metrics``."""
    monkeypatch.setattr(module, "run_experiment",
                        lambda *a, **k: dict(metrics))
    args = argparse.Namespace(input_dir="records", output_dir=output_dir,
                              batch_size=8, epochs=1, mixed_precision=False,
                              verbose=0)
    module._run_one(args, os.path.join(output_dir, "results.jsonl"),
                    threading.Lock(), session, params)


@pytest.mark.parametrize("writer,reader", [(jax_search, search),
                                           (search, jax_search)])
def test_summarize_reads_the_other_package(tmp_path, monkeypatch, capsys,
                                           writer, reader):
    out = str(tmp_path / "sweepz")
    os.makedirs(out)
    for session, nd, mean in ((1, 4, 0.9), (2, 8, 0.1)):
        write_results_line(writer, out, session,
                           dict(TINY_GRID, noise_dim=nd),
                           {"signals_metrics/mean": mean}, monkeypatch)
    capsys.readouterr()
    rows = reader.summarize(out)
    assert [r["session"] for r in rows] == [2, 1]
    text = capsys.readouterr().out
    assert text.index("      2") < text.index("      1")


def test_summarize_ranks_by_metric(tmp_path, capsys):
    out = str(tmp_path / "sweepz")
    os.makedirs(out)
    with open(os.path.join(out, "results.jsonl"), "w") as f:
        f.write(json.dumps({"session": 1, "params": {"noise_dim": 4},
                            "metrics": {"signals_metrics/mean": 0.9}}) + "\n")
        f.write(json.dumps({"session": 2, "params": {"noise_dim": 8},
                            "metrics": {"signals_metrics/mean": 0.1}}) + "\n")
    rows = search.summarize(out)
    assert [r["session"] for r in rows] == [2, 1]
    text = capsys.readouterr().out
    assert text.index("      2") < text.index("      1")
    assert search.summarize(str(tmp_path / "none")) == []


def test_search_grid_override(tmp_path, dataset_dir, monkeypatch):
    """--grid replaces listed DEFAULT_GRID entries (unlisted keep defaults)
    and rejects unknown keys."""
    monkeypatch.setattr(search, "DEFAULT_GRID",
                        dict(TINY_GRID, noise_dim=[4, 8, 16]))
    args = sweep_args(dataset_dir, str(tmp_path / "sweep"),
                      grid=json.dumps({"noise_dim": [4]}))
    search.search(args)
    lines = read_results(args.output_dir)
    assert len(lines) == 1 and lines[0]["params"]["noise_dim"] == 4

    args.grid = json.dumps({"bogus_key": [1]})
    args.output_dir = str(tmp_path / "sweep2")
    with pytest.raises(ValueError, match="bogus_key"):
        search.search(args)


@pytest.mark.parametrize("input_dir", ["dataset/", "runs/surrogate"])
def test_experiment_config_equals_jax(input_dir):
    args = argparse.Namespace(input_dir=input_dir, output_dir="runs/sweep",
                              batch_size=64, epochs=400,
                              mixed_precision=True, verbose=1)
    assert search.DEFAULT_GRID == jax_search.DEFAULT_GRID
    names = list(search.DEFAULT_GRID)
    for session, values in enumerate(
            itertools.product(*search.DEFAULT_GRID.values()), start=1):
        params = dict(zip(names, values))
        ours = search.experiment_config(args, session, params)
        theirs = jax_search.experiment_config(args, session, params)
        assert ours.output_dir == theirs.output_dir
        # the port's own fields (Adam's betas) keep their defaults
        mine = dataclasses.asdict(ours)
        own = {k: mine.pop(k) for k in port_config.PORT_FIELDS}
        assert own == {"adam_beta1": 0.9, "adam_beta2": 0.999}
        assert mine == dataclasses.asdict(theirs)
    assert ours.surrogate_ds == ("surrogate" in input_dir)
    assert os.path.basename(ours.output_dir) == \
        "054_calciumgan_units32_kl4_strides1_ps1_leakyrelu_nd16"


def test_session_order_and_schema_equal_jax(tmp_path, monkeypatch):
    """Both sweeps visit the same (session, params) in the same order and
    write the same schema event, byte for byte with the clock patched."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    grid = json.dumps({"noise_dim": [4, 16], "num_units": [8, 32],
                       "phase_shuffle": [0, 1]})
    visited, files = {}, {}
    for name, module in (("jax", jax_search), ("port", search)):
        visited[name] = []
        monkeypatch.setattr(
            module, "_run_one",
            lambda *a, _seen=visited[name], **k: _seen.append(a[3:5]))
        out = str(tmp_path / name)
        module.search(sweep_args("records", out, grid=grid))
        [files[name]] = glob.glob(os.path.join(out, "events.out.tfevents.*"))
    assert visited["port"] == visited["jax"]
    # 2 noise_dim x 2 num_units x 3 kernel_size x 2 phase_shuffle
    assert [s for s, _ in visited["port"]] == list(range(1, 25))
    with open(files["port"], "rb") as f, open(files["jax"], "rb") as g:
        assert f.read() == g.read()


def test_hparams_events_byte_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    domains = {"model": ["calciumgan", "mlp"], "noise_dim": [4, 8, 16],
               "gradient_penalty": [10.0], "layer_norm": [True, False],
               "empty": []}
    values = {"model": "calciumgan", "noise_dim": 16, "dropout": 0.2,
              "layer_norm": True}
    blobs = {}
    for name, module in (("jax", jax_tb), ("port", port_tb)):
        writer = module.EventWriter(str(tmp_path / name))
        writer.hparams_config(domains, search.METRIC_TAGS)
        writer.hparams(values, group_name="007")
        writer.hparams(values)
        writer.close()
        [path] = glob.glob(str(tmp_path / name / "events.out.tfevents.*"))
        with open(path, "rb") as f:
            blobs[name] = f.read()
    assert blobs["port"] == blobs["jax"]
    assert blobs["port"].count(b"_hparams_/session_start_info") == 2
