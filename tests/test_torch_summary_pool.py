"""The port's figure render pool (``Summary(workers=N)``) and
``compute_metrics --num_processors``, on the CPU.

Mirrors ``tests/test_utils.py:372-403``: a pooled ``Summary`` renders every
figure in spawned workers and ``close()`` writes them into the event files;
without figures no pool starts. Held beyond that: the pooled figures, saved and in
the event files, are the inline ones byte for byte, and ``compute_metrics --num_processors 2``
writes the same ``metrics.json`` and the same figures as ``0`` on a
fabricated run directory (``tests/test_torch_eval.py``'s).
"""

import glob
import importlib.util
import json
import os

import numpy as np

from calciumgan_tpu.data.tfrecord import _walk, read_records
from calciumgan_tpu.utils.tb_reader import read_scalars
from calciumgan_tpu_torch import compute_metrics as port_cli
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.utils.summary import Summary
from test_torch_eval import make_run


def draw_figures(summary):
    rng = np.random.default_rng(0)
    summary.plot_distribution("dist_a", rng.uniform(size=50), step=1)
    summary.plot_histograms_grid("grid", [(rng.normal(size=20),
                                           rng.normal(size=20))] * 2,
                                 titles=["a", "b"], step=1)
    summary.scalar("kl", 0.5, step=1)


def pngs(plots_dir):
    out = {}
    for path in sorted(glob.glob(os.path.join(plots_dir, "*.png"))):
        with open(path, "rb") as f:
            out[os.path.basename(path)] = f.read()
    return out


def images(logdir):
    """{(tag, step): encoded PNG} of the image summaries in ``logdir``'s
    event files, read with the JAX package's record walker."""
    out = {}
    for path in glob.glob(os.path.join(logdir, "events.out.tfevents.*")):
        for record in read_records(path):
            fields = list(_walk(record))
            step = next((v for f, w, v in fields if f == 2 and w == 0), 0)
            for field, wire, summary in fields:
                if field != 5 or wire != 2:
                    continue
                for _, _, value in _walk(summary):   # Summary.value
                    parts = {f: v for f, _, v in _walk(value)}
                    if 4 in parts:                   # Value.image
                        png = {f: v for f, _, v in _walk(parts[4])}[4]
                        out[(parts[1].decode(), step)] = png
    return out


def test_summary_pool_mode_renders_figures(tmp_path):
    """workers>0 renders in a spawn pool; close() collects every figure,
    the same PNGs as inline rendering."""
    rendered = {}
    for workers in (0, 2):
        cfg = Config(output_dir=str(tmp_path / f"run{workers}"), dpi=60)
        os.makedirs(cfg.output_dir, exist_ok=True)
        s = Summary(cfg, spike_metrics=True, workers=workers)
        draw_figures(s)
        assert (s._pool is not None) == bool(workers)
        s.close()
        assert s._pool is None and not s._pending
        plots_dir = os.path.join(cfg.output_dir, "metrics", "plots")
        rendered[workers] = (pngs(plots_dir),)
        assert {p.split("_step")[0] for p in rendered[workers][0]} == \
            {"dist_a", "grid"}
        assert os.path.exists(os.path.join(plots_dir, "dist_a.pdf"))
        logdir = os.path.join(cfg.output_dir, "metrics")
        rendered[workers] += (images(logdir),)
        assert set(rendered[workers][1]) == {("dist_a/image/0", 1),
                                             ("grid/image/0", 1)}
        assert read_scalars(logdir)["kl"] == {1: 0.5}
    assert rendered[2] == rendered[0]


def test_summary_no_plots_mode_starts_no_pool(tmp_path, monkeypatch):
    cfg = Config(output_dir=str(tmp_path / "run"), dpi=60)
    os.makedirs(cfg.output_dir, exist_ok=True)
    s = Summary(cfg, spike_metrics=True, no_plots=True, workers=2)
    draw_figures(s)
    assert s._pool is None
    s.close()
    assert not glob.glob(
        os.path.join(cfg.output_dir, "metrics", "plots", "*.png"))
    assert glob.glob(
        os.path.join(cfg.output_dir, "metrics", "events.out.tfevents.*"))
    # nor where matplotlib is missing, as on the card's machine
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    s = Summary(cfg, spike_metrics=True, workers=2)
    draw_figures(s)
    assert s.no_plots and s._pool is None
    s.close()


def test_compute_metrics_num_processors_renders_through_the_pool(
        tmp_path, monkeypatch):
    workers = []

    class Spy(Summary):
        def __init__(self, *args, **kwargs):
            workers.append(kwargs.get("workers", 0))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(port_cli, "Summary", Spy)
    monkeypatch.setattr(port_cli.os, "cpu_count", lambda: 8)
    results = {}
    for n in (0, 2):
        run = str(tmp_path / f"run{n}")
        make_run(run, "port")
        config, options = port_cli.parse_args(
            ["--output_dir", run, "--all_epochs", "--device", "cpu",
             "--verbose", "0", "--num_neuron_plots", "3",
             "--num_trial_plots", "2", "--num_processors", str(n)])
        port_cli.main(config, **options)
        with open(os.path.join(run, "metrics", "metrics.json")) as f:
            metrics = json.load(f)
        plots_dir = os.path.join(run, "metrics", "plots")
        results[n] = (metrics, sorted(os.listdir(plots_dir)),
                      images(os.path.join(run, "metrics")))
        assert len(results[n][2]) == len(pngs(plots_dir)) > 0
    assert workers == [0, 2]
    assert results[2] == results[0]
