"""Hyper-parameter grid search (counterpart of ``search.py`` at the repo
root; same flags, plus ``--device``).

    python -m calciumgan_tpu_torch.search --input_dir RECORDS \\
        --output_dir runs/sweep --device cuda [--parallel N] [--summarize]

Every point of ``DEFAULT_GRID`` (or of ``--grid``'s overrides) trains one
experiment through :func:`calciumgan_tpu_torch.train.main`, numbered from 1
in ``itertools.product`` order, into ``<output_dir>/NNN_<model>_units...``
with the JAX package's names and ``Config`` fields. An experiment whose
directory exists is skipped ("already exists"); a failing one prints
``ERROR`` and the sweep goes on. Each finished experiment writes its
``hparams`` and ``test/<metric>`` scalars at step ``epochs + 1`` to
``<experiment>/test`` and appends one line to ``<output_dir>/results.jsonl``
(the JAX package's schema: either package's ``--summarize`` reads the
other's file). The sweep's ``hparams_config`` schema goes to
``<output_dir>``.

``--parallel N`` splits the visible devices into N equal slices, one
spawned worker process per slice, and raises unless the device count
divides by N, as the JAX package does: the GPUs with ``--device cuda``, N
host workers with ``--device cpu``. A worker whose slice holds more than
one GPU trains each of its experiments data-parallel over the slice, one
rank per GPU (:func:`calciumgan_tpu_torch.train.run`), as the JAX package
trains it on the slice's mesh.
"""

from __future__ import annotations

import argparse
import itertools
import json
import multiprocessing
import os
import threading
import traceback
import warnings
from shutil import rmtree
from time import time

import torch

from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.utils.device import resolve_device
from calciumgan_tpu_torch.utils.tb import EventWriter

DEFAULT_GRID = {
    "algorithm": ["wgan-gp"],
    "model": ["calciumgan"],
    "activation": ["leakyrelu"],
    "noise_dim": [4, 8, 16],
    "num_units": [8, 16, 32],
    "kernel_size": [2, 3, 4],
    "strides": [1],
    "phase_shuffle": [0, 1],
    "gradient_penalty": [10.0],
    "n_critic": [5],
}

METRIC_TAGS = ["test/signals_metrics/min", "test/signals_metrics/max",
               "test/signals_metrics/mean", "test/signals_metrics/std"]


def experiment_config(args, session: int, params: dict) -> Config:
    cfg = Config(
        input_dir=args.input_dir,
        output_dir=os.path.join(
            args.output_dir,
            "{:03d}_{}_units{}_kl{}_strides{}_ps{}_{}_nd{}".format(
                session, params["model"], params["num_units"],
                params["kernel_size"], params["strides"],
                params["phase_shuffle"], params["activation"],
                params["noise_dim"])),
        batch_size=args.batch_size,
        num_units=params["num_units"],
        kernel_size=params["kernel_size"],
        strides=params["strides"],
        m=params["phase_shuffle"],
        n=params["phase_shuffle"],
        epochs=args.epochs,
        dropout=0.2,
        learning_rate=1e-4,
        noise_dim=params["noise_dim"],
        gradient_penalty=params["gradient_penalty"],
        model=params["model"],
        activation=params["activation"],
        layer_norm=True,
        algorithm=params["algorithm"],
        n_critic=params["n_critic"],
        save_generated="last",
        mixed_precision=args.mixed_precision,
        verbose=args.verbose,
    )
    cfg.surrogate_ds = "surrogate" in args.input_dir
    return cfg


def run_experiment(config: Config, session: int, params: dict,
                   device="cuda", devices=None) -> dict:
    """Train one experiment on ``device``, or data-parallel over
    ``devices`` (a slice of the GPUs), and write its test scalars."""
    from calciumgan_tpu_torch.train import run as train

    print(f"\nExperiment {session:03d}\n"
          "-----------------------------------------")
    for key, value in params.items():
        print(f"\t{key}: {value}")

    metrics = train(config, device=device, return_metrics=True,
                    devices=devices)

    writer = EventWriter(os.path.join(config.output_dir, "test"))
    # per-trial values for the TensorBoard HParams dashboard
    writer.hparams(params, group_name=f"{session:03d}")
    for key, item in metrics.items():
        writer.scalar(f"test/{key}", item, step=config.epochs + 1)
    writer.close()
    return metrics


def _run_one(args, results_path, lock, session, params, device="cuda",
             devices=None):
    config = experiment_config(args, session, params)
    if os.path.exists(config.output_dir):
        print(f"Experiment {config.output_dir} already exists")
        return
    try:
        start = time()
        metrics = run_experiment(config, session, params, device=device,
                                 devices=devices)
        elapse = time() - start
        print(f"\nExperiment {session:03d} completed "
              f"in {elapse / 3600:.2f}hrs\n")
        with lock, open(results_path, "a") as f:
            f.write(json.dumps({
                "session": session, "params": params,
                "metrics": {k: float(v) for k, v in metrics.items()},
                "elapse": elapse}) + "\n")
    except Exception as e:
        print(f"\nExperiment {session:03d} ERROR: {e}")
        if args.verbose:
            traceback.print_exc()


def device_slices(device: str, parallel: int) -> list:
    """The devices of each worker: ``parallel`` equal, contiguous slices of
    the visible GPUs for a CUDA ``device`` (raising as the JAX package does
    unless their count divides by ``parallel``), or one host each for the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return [["cpu"] for _ in range(parallel)]
    count = torch.cuda.device_count()
    if count % parallel:
        raise ValueError(f"{count} devices not divisible by "
                         f"--parallel {parallel}")
    per = count // parallel
    return [[f"cuda:{i}" for i in range(w * per, (w + 1) * per)]
            for w in range(parallel)]


def _worker(args, results_path, lock, queue, devices):
    """One ``--parallel`` worker: its slice's first device, then
    experiments from ``queue`` until a ``None``, each on its one device or
    data-parallel over its slice."""
    device = devices[0]
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)  # before any other CUDA call
    for session, params in iter(queue.get, None):
        _run_one(args, results_path, lock, session, params, device=device,
                 devices=devices)


def search(args):
    if args.clear_output_dir and os.path.exists(args.output_dir):
        rmtree(args.output_dir)
    os.makedirs(args.output_dir, exist_ok=True)

    grid = dict(DEFAULT_GRID)
    if getattr(args, "grid", None):
        overrides = json.loads(args.grid)
        unknown = set(overrides) - set(grid)
        if unknown:
            raise ValueError(f"--grid keys not in the sweep space: "
                             f"{sorted(unknown)} (valid: {sorted(grid)})")
        grid.update(overrides)
    results_path = os.path.join(args.output_dir, "results.jsonl")

    # sweep schema for the TensorBoard HParams dashboard
    schema_writer = EventWriter(args.output_dir)
    schema_writer.hparams_config(grid, METRIC_TAGS)
    schema_writer.close()

    names = list(grid.keys())
    sessions = [(s, dict(zip(names, values))) for s, values in enumerate(
        itertools.product(*grid.values()), start=1)]

    device = getattr(args, "device", "cuda")
    parallel = getattr(args, "parallel", 1)
    if parallel <= 1:
        lock = threading.Lock()
        for session, params in sessions:
            _run_one(args, results_path, lock, session, params,
                     device=device)
    else:
        # experiment parallelism: a spawned process per device slice (no
        # worker inherits the parent's CUDA state), fed from one queue
        devices = device_slices(device, parallel)
        ctx = multiprocessing.get_context("spawn")
        lock, queue = ctx.Lock(), ctx.Queue()
        for item in sessions + [None] * parallel:
            queue.put(item)
        workers = [ctx.Process(target=_worker, args=(
            args, results_path, lock, queue, dev)) for dev in devices]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        failed = [w.exitcode for w in workers if w.exitcode]
        if failed:
            raise RuntimeError(f"--parallel workers exited with {failed}")

    print(f"\nExperiment completed, TensorBoard log at {args.output_dir}")


def summarize(output_dir: str, sort_by: str = "signals_metrics/mean",
              top: int = 20):
    """Print the sweep ranked by a test metric (ascending)."""
    path = os.path.join(output_dir, "results.jsonl")
    if not os.path.exists(path):
        print(f"{path} not found")
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    rows.sort(key=lambda r: r["metrics"].get(sort_by, float("inf")))
    print(f"{'session':>7}  {sort_by:>24}  params")
    for r in rows[:top]:
        changing = {k: v for k, v in r["params"].items()
                    if k in ("noise_dim", "num_units", "kernel_size",
                             "phase_shuffle", "strides")}
        print(f"{r['session']:>7}  "
              f"{r['metrics'].get(sort_by, float('nan')):>24.6f}  "
              f"{changing}")
    return rows


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", default="dataset/")
    parser.add_argument("--output_dir", default="runs/hparams_turning")
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--epochs", default=400, type=int)
    parser.add_argument("--clear_output_dir", action="store_true")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device of every experiment ('cpu' "
                             "trains on the host)")
    parser.add_argument("--parallel", default=1, type=int,
                        help="run N experiments concurrently, each on its "
                             "own 1/N slice of the visible devices")
    parser.add_argument("--grid", default=None, type=str,
                        help="JSON dict overriding DEFAULT_GRID entries, "
                             "e.g. '{\"noise_dim\": [4, 8]}' (unlisted keys "
                             "keep their defaults)")
    parser.add_argument("--verbose", default=0, type=int)
    parser.add_argument("--summarize", action="store_true",
                        help="print the sweep ranked by --sort_by and exit")
    parser.add_argument("--sort_by", default="signals_metrics/mean", type=str)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.verbose == 0:
        warnings.simplefilter(action="ignore", category=UserWarning)
        warnings.simplefilter(action="ignore", category=RuntimeWarning)
    if args.summarize:
        return summarize(args.output_dir, sort_by=args.sort_by)
    resolve_device(args.device)  # --device cuda without a card raises
    return search(args)


if __name__ == "__main__":
    main()
