"""Post-hoc spike-metric evaluation of a trained run (counterpart of
``compute_metrics.py`` at the repo root; same flags, plus ``--device``).

    python -m calciumgan_tpu_torch.compute_metrics --output_dir runs/001 \\
        --all_epochs --device cuda

Reads ``<output_dir>/generated/info.pkl`` (written by training with
``--save_generated``), deconvolves every epoch file's signals on
``--device`` (the OASIS CUDA kernel on a GPU) and compares the spike
statistics of generated and recorded data: firing rate, binned correlation,
van Rossum distance, and behind flags covariance and Victor-Purpura
distance. The mean KL per statistic and epoch, and the best epoch per
statistic, go to ``<output_dir>/metrics/metrics.json``; scalars and figures
to ``<output_dir>/metrics``. ``--device cuda`` (the default) without a card
raises; ``--device cpu`` runs on the host. Figures render in a pool of up
to ``--num_processors`` spawned processes (at most one fewer than the
host's cores; inline where that leaves none), as the JAX CLI's do.
"""

import argparse
import json
import os
from time import time

import numpy as np

from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.eval import spike_eval
from calciumgan_tpu_torch.utils import h5, io
from calciumgan_tpu_torch.utils.device import resolve_device
from calciumgan_tpu_torch.utils.summary import Summary


def main(config, with_covariance: bool = False,
         with_victor_purpura: bool = False, no_plots: bool = False,
         device="cuda", seconds=None):
    """Evaluate the run ``config.output_dir`` on ``device``; returns epoch
    -> mean KL per statistic. A ``seconds`` dict, when given, gets epoch ->
    the seconds of that epoch file's stages
    (:func:`spike_eval.compute_epoch_spike_metrics`)."""
    device = resolve_device(device)
    if not os.path.exists(config.output_dir):
        print(f"{config.output_dir} not found")
        raise SystemExit(1)

    rng = np.random.default_rng(config.seed)
    config.load()  # re-attach the training run's hparams.json
    info = io.load_generated_info(config)

    epochs = sorted(info.keys())

    # epochs whose file is gone (deleted / moved run dir) can't be
    # evaluated: drop them BEFORE the default last-epoch slice so a
    # missing newest file falls back to the newest evaluable one, and
    # fail loudly when nothing remains
    missing = [e for e in epochs if not os.path.exists(info[e]["filename"])]
    if missing:
        for e in missing:
            print(f"warning: skipping epoch {e}: "
                  f"{info[e]['filename']} does not exist")
        epochs = [e for e in epochs if e not in set(missing)]
    if not epochs:
        raise FileNotFoundError(
            f"no generated epoch files found under {config.output_dir}: "
            "was the run trained with --save_generated?")
    if not config.all_epochs:
        epochs = [epochs[-1]]  # only the last generated file by default

    # clamp to the SHORTEST file in play: a crash-interrupted re-validation
    # can leave an epoch file with fewer trials than the validation cache;
    # indexing real rows against missing fake rows would crash mid-metric
    epoch_lengths = [
        h5.get_dataset_length(info[e]["filename"], "signals") for e in epochs]
    config.num_samples = min(
        h5.get_dataset_length(config.validation_cache, "signals"),
        min(epoch_lengths), 1000)

    # randomly select neurons and trials to plot (reference
    # compute_metrics.py:519-525), in the JAX CLI's order of draws
    if config.num_neuron_plots >= config.num_neurons:
        config.neurons = list(range(config.num_neurons))
    else:
        config.neurons = [int(i) for i in rng.choice(
            config.num_neurons, config.num_neuron_plots, replace=False)]
    config.trials = [int(i) for i in rng.choice(
        config.num_samples, min(config.num_trial_plots, config.num_samples),
        replace=False)]

    # figures render in a process pool (matplotlib is the host work worth
    # fanning out beside the card's); on a single-core host the pool only
    # adds spawn and pickling, so the worker count follows the cores
    workers = 0 if no_plots else min(config.num_processors,
                                     max(0, (os.cpu_count() or 1) - 1))
    summary = Summary(config, spike_metrics=True, no_plots=no_plots,
                      workers=workers)

    # real spikes are epoch-invariant: load the validation cache once
    real_spikes = spike_eval._load_spikes(config, config.validation_cache,
                                          config.num_samples, device)
    all_results = {}
    for epoch in epochs:
        start = time()
        if config.verbose:
            print(f"\nCompute metrics for {info[epoch]['filename']}")
        all_results[epoch] = spike_eval.compute_epoch_spike_metrics(
            config, summary, filename=info[epoch]["filename"], epoch=epoch,
            rng=rng, with_covariance=with_covariance,
            with_victor_purpura=with_victor_purpura,
            real_spikes=real_spikes, device=device,
            seconds=None if seconds is None else seconds.setdefault(epoch,
                                                                    {}))
        elapse = time() - start
        summary.scalar("elapse/spike_metrics", elapse, step=epoch)
        if config.verbose:
            print(f"{info[epoch]['filename']} took {elapse / 60:.02f} mins")
    summary.close()

    # persist epoch -> KL scalars (the event files hold the same numbers,
    # but a JSON is what sweep tooling and notebooks consume) and point at
    # the best epoch per metric: WGAN KLs oscillate epoch to epoch, so the
    # argmin over the checkpointed history is the number a user publishes
    metrics_path = os.path.join(config.output_dir, "metrics",
                                "metrics.json")
    os.makedirs(os.path.dirname(metrics_path), exist_ok=True)
    best = {k: min(all_results, key=lambda e: all_results[e][k])
            for k in next(iter(all_results.values()))}
    with open(metrics_path + ".tmp", "w") as f:
        json.dump({"epochs": {str(e): r for e, r in all_results.items()},
                   "best_epoch": {k: int(e) for k, e in best.items()}},
                  f, indent=2)
    os.replace(metrics_path + ".tmp", metrics_path)
    if config.verbose:
        print(f"\nwrote {metrics_path}")
        for k, e in best.items():
            print(f"\tbest {k}: epoch {e} ({all_results[e][k]:.4f})")
    return all_results


def parse_args(argv=None):
    """``(config, options)`` from the command line: ``options`` holds what
    is no field of the run's configuration (the device, ``--no_plots``,
    ``--covariance``, ``--victor_purpura``)."""
    # Defaults are SUPPRESS so Config.from_args sees exactly the flags the
    # user typed; Config.load then never clobbers them with the training
    # run's persisted values (reference contract: eval flags always win,
    # gan/utils/utils.py:78-84). Untyped flags fall back to the Config
    # dataclass defaults (the values annotated below).
    S = argparse.SUPPRESS
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device for the OASIS kernel and the "
                             "statistics ('cpu' runs on the host)")
    parser.add_argument("--output_dir", default=S, help="(default: runs)")
    parser.add_argument("--num_processors", default=S, type=int,
                        help="processes of the figure render pool "
                             "(default: 6; 0 renders inline)")
    parser.add_argument("--all_epochs", action="store_true", default=S)
    parser.add_argument("--no_plots", action="store_true", default=False,
                        help="skip all matplotlib figures; compute and "
                             "record the KL scalars only (fast sweep mode)")
    parser.add_argument("--covariance", action="store_true", default=False,
                        help="also compute covariance metrics (the "
                             "reference implements but disables these)")
    parser.add_argument("--victor_purpura", action="store_true",
                        default=False,
                        help="also compute Victor-Purpura distance metrics "
                             "(the reference implements but never calls "
                             "these)")
    parser.add_argument("--num_neuron_plots", default=S, type=int,
                        help="(default: 6)")
    parser.add_argument("--num_trial_plots", default=S, type=int,
                        help="(default: 6)")
    parser.add_argument("--plots_per_row", default=S, type=int,
                        help="(default: 3)")
    parser.add_argument("--dpi", default=S, type=int, help="(default: 120)")
    parser.add_argument("--format", default=S, choices=["pdf", "png"],
                        help="(default: pdf)")
    parser.add_argument("--verbose", default=S, type=int,
                        help="(default: 1)")
    parser.add_argument("--seed", default=12, type=int)
    args = parser.parse_args(argv)
    options = dict(device=args.device, no_plots=args.no_plots,
                   with_covariance=args.covariance,
                   with_victor_purpura=args.victor_purpura)
    del args.device, args.covariance, args.victor_purpura, args.no_plots
    return Config.from_args(args), options


def cli(argv=None):
    config, options = parse_args(argv)
    return main(config, **options)


if __name__ == "__main__":
    cli()
