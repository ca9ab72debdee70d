"""DG-experiment fidelity metrics: firing rate and covariance of the DG data
against the generated data, as MAE / RMSE / MAPE (counterpart of
``compute_dg_metrics.py`` at the repo root; same flags, plus ``--device``).

    python -m calciumgan_tpu_torch.compute_dg_metrics --output_dir runs/dg \\
        --device cuda

Reads the run's validation cache and its newest generated epoch file
(training with ``--save_generated``), deconvolves the generated signals on
``--device`` where the file has no spikes yet (the OASIS CUDA kernel on a
GPU) and computes both statistics there for ``--num_trials`` trials at once.
``--device cuda`` (the default) without a card raises; ``--device cpu`` runs
on the host. ``--save_plots`` writes the two scatter plots under
``diagrams/``; matplotlib is imported then, and without it one line says
that they are skipped.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import warnings

import numpy as np
import torch

from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.eval.spike_eval import ensure_spikes
from calciumgan_tpu_torch.ops import spike_metrics as sm
from calciumgan_tpu_torch.utils import arrays, h5, io, plots
from calciumgan_tpu_torch.utils.device import resolve_device


def get_data_statistics(config, filename, device="cpu"):
    """(num_neurons, num_trials) firing rates and (P, num_trials) binned
    upper-triangle covariances (k=0), NaN -> 0, computed on ``device``."""
    # infer the on-disk layout from metadata, then read only the
    # num_trials rows actually used when the trial axis leads: reading
    # the whole dataset to keep 5 trials costs GBs on production runs
    fmt = arrays.get_array_format(h5.get_shape(filename, "spikes"), config)
    if fmt[0] == "N":
        raw = h5.get(filename, "spikes", start=0, stop=config.num_trials)
    else:
        raw = h5.get(filename, "spikes")
    perm = [fmt.index(s) for s in "NCW"]
    spikes = np.transpose(np.asarray(raw, np.float32), perm)
    spikes_ncw = torch.from_numpy(np.ascontiguousarray(
        spikes[:config.num_trials])).to(device)          # (N, C, W)
    rates = sm.mean_firing_rate(spikes_ncw)               # (N, C)
    C = config.num_neurons
    iu = torch.triu_indices(C, C, device=spikes_ncw.device)
    covs = sm.covariance(spikes_ncw)[:, iu[0], iu[1]]     # (N, P)
    return (rates.T.cpu().numpy().astype(np.float32),
            np.nan_to_num(covs.T.cpu().numpy()).astype(np.float32))


def _scatter_plot(config, filename, real, fake, order, xlabel, ylabel,
                  tick_step, legend=None):
    real = real[order].flatten("F")
    fake = fake[order].flatten("F")
    x = np.tile(np.arange(len(order)), config.num_trials)

    fig = plots._figure((8, 6))
    ax = fig.add_subplot(1, 1, 1)
    ax.scatter(x, real, marker="o", color=plots.REAL_COLOR, alpha=0.6)
    ax.scatter(x, fake, marker="x", color=plots.FAKE_COLOR, alpha=0.6)
    ax.set_xticks(list(range(0, len(order), tick_step)))
    ax.set_xticklabels(order[::tick_step], rotation=90)
    plots._despine(ax)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if legend:
        ax.legend(labels=legend, loc="upper left", frameon=False)
    fig.tight_layout()
    fig.savefig(filename, dpi=120, format=config.format, transparent=True)
    print(f"saved figure to {filename}")


def plot_firing_rate(config, filename, real, fake):
    order = np.argsort(np.mean(real, axis=-1))
    _scatter_plot(config, filename, real, fake, order,
                  xlabel="Neuron", ylabel="Firing rate", tick_step=5,
                  legend=["DG", "CalciumGAN"])


def plot_covariance(config, filename, real, fake):
    order = np.argsort(np.mean(real, axis=-1))[::10]  # every 10th pair
    _scatter_plot(config, filename, real, fake, order,
                  xlabel="Neuron Pair", ylabel="Covariance", tick_step=20)


def percentage_error(y_true, y_pred):
    """Reference semantics: zero targets fall back to y_pred /
    mean(y_true)."""
    error = np.empty(y_true.shape)
    nonzero = y_true != 0.0
    error[nonzero] = (y_true[nonzero] - y_pred[nonzero]) / y_true[nonzero]
    error[~nonzero] = y_pred[~nonzero] / np.mean(y_true)
    return error


def mean_absolute_percentage_error(y_true, y_pred):
    errors = np.stack([percentage_error(y_true[..., i], y_pred[..., i])
                       for i in range(y_true.shape[1])], axis=-1)
    return float(np.mean(np.mean(np.abs(errors), axis=0), axis=0)) * 100


def main(config, device="cuda", seconds=None):
    """Evaluate the run ``config.output_dir`` on ``device``; returns
    ``{"firing_rate": {mae, rmse, mape}, "covariance": {mae, mse, mape}}``.
    A ``seconds`` dict, when given, gets the seconds of the generated
    file's deconvolution by stage (:func:`~calciumgan_tpu_torch.eval.
    spike_eval.deconvolve_file`)."""
    device = resolve_device(device)
    if not os.path.exists(config.output_dir):
        print(f"{config.output_dir} not found")
        raise SystemExit(1)

    config.load()
    info = io.load_generated_info(config)
    epochs = sorted(info.keys())
    fake_file = info[epochs[-1]]["filename"]

    config.num_samples = h5.get_dataset_length(config.validation_cache,
                                               "signals")
    stages = ensure_spikes(config, fake_file, device=device)
    if seconds is not None and stages:
        seconds.update(stages)

    real_fr, real_cov = get_data_statistics(config, config.validation_cache,
                                            device)
    fake_fr, fake_cov = get_data_statistics(config, fake_file, device)

    if config.save_plots:
        if importlib.util.find_spec("matplotlib") is None:
            print("matplotlib is not installed: figures are skipped")
        else:
            os.makedirs("diagrams", exist_ok=True)
            plot_firing_rate(
                config, os.path.join("diagrams",
                                     f"dg_firing_rate.{config.format}"),
                real=real_fr, fake=fake_fr)
            plot_covariance(
                config, os.path.join("diagrams",
                                     f"dg_covariance.{config.format}"),
                real=real_cov, fake=fake_cov)

    fr_mae = np.mean(np.abs(real_fr - fake_fr))
    fr_rmse = np.sqrt(np.mean(np.square(real_fr - fake_fr)))
    fr_mape = mean_absolute_percentage_error(real_fr, fake_fr)
    print(f"\nmean firing rate\n\tMAE\t{fr_mae:.02f}"
          f"\n\tRMSE\t{fr_rmse:.02f}\n\tMAPE\t{fr_mape:.02f}%")

    cov_mae = np.mean(np.abs(real_cov - fake_cov))
    cov_mse = np.mean(np.square(real_cov - fake_cov))
    cov_mape = mean_absolute_percentage_error(real_cov, fake_cov)
    print(f"\ncovariance\n\tMAE\t{cov_mae:.02f}\n\tMSE\t{cov_mse:.02f}"
          f"\n\tMAPE\t{cov_mape:.02f}%")

    return {"firing_rate": {"mae": float(fr_mae), "rmse": float(fr_rmse),
                            "mape": fr_mape},
            "covariance": {"mae": float(cov_mae), "mse": float(cov_mse),
                           "mape": cov_mape}}


def parse_args(argv=None):
    """``(config, device)`` from the command line."""
    # SUPPRESS defaults: only typed flags reach Config.from_args, so
    # Config.load never clobbers them (eval flags always win)
    S = argparse.SUPPRESS
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device for the OASIS kernel and the "
                             "statistics ('cpu' runs on the host)")
    parser.add_argument("--output_dir", default=S, type=str,
                        help="(default: runs)")
    parser.add_argument("--num_trials", default=S, type=int,
                        help="(default: 5)")
    parser.add_argument("--save_plots", action="store_true", default=S)
    parser.add_argument("--format", default=S, choices=["pdf", "png"],
                        help="(default: pdf)")
    args = parser.parse_args(argv)
    device = args.device
    del args.device
    return Config.from_args(args), device


def cli(argv=None):
    config, device = parse_args(argv)
    warnings.simplefilter(action="ignore", category=UserWarning)
    warnings.simplefilter(action="ignore", category=RuntimeWarning)
    return main(config, device=device)


if __name__ == "__main__":
    cli()
