"""Epoch-file spike-metric evaluation (counterpart of
``calciumgan_tpu/eval/spike_eval.py``).

Re-design of the reference's ``compute_metrics.py`` pipeline (``:35-502``)
as the JAX package has it: every process-pool fan-out (deconvolution per
neuron, firing rate per neuron, correlation per trial, van Rossum per
neuron/trial) is one batched tensor program over the population tensor on
the device the caller names; the host does the file IO, the greedy heatmap
sort and matplotlib.

Deconvolution goes through
:func:`calciumgan_tpu_torch.ops.oasis.deconvolve_signals_host`: the OASIS
CUDA kernel where the traces lie on a GPU, its plain PyTorch version on the
CPU, flagged traces recomputed in float64 where they lie. Epoch files are read
and written through :mod:`calciumgan_tpu_torch.utils.h5`, whose container
follows the file's name.
"""

from __future__ import annotations

import collections
from time import perf_counter
from typing import Dict, Optional

import numpy as np
import torch

from calciumgan_tpu_torch.ops import spike_metrics as sm
from calciumgan_tpu_torch.ops.oasis import deconvolve_signals_host
from calciumgan_tpu_torch.utils import arrays, h5, tracing

# traces per dispatch of the OASIS kernel on a GPU, and per call of its
# plain version on the CPU (the JAX package's chunk sizes)
_CHUNK_TRACES_CUDA, _CHUNK_TRACES_CPU = 16384, 512


# ---------------------------------------------------------------------------
# deconvolution
# ---------------------------------------------------------------------------

def deconvolve_traces(traces) -> np.ndarray:
    """Binary spikes (host ``np.int8``) of ``(..., T)`` traces, a tensor on
    the CPU or the GPU or a numpy array. The OASIS kernel runs where the
    traces lie: the CUDA kernel on the GPU, its plain PyTorch version on the
    CPU; flagged traces are recomputed in float64 where the traces lie
    (:func:`calciumgan_tpu_torch.ops.oasis.deconvolve_signals_host`, which
    names the spans and counts it adds to
    :mod:`~calciumgan_tpu_torch.utils.tracing`). The spikes take the traces'
    shape and strides (a permuted view gives spikes laid out as the tensor
    it views) on either device; from the GPU they cross to the host by DMA
    into page-locked memory."""
    return deconvolve_signals_host(traces)


def deconvolve_file(config, filename: str, chunk: int = 0,
                    device="cpu") -> Dict[str, float]:
    """Append an int8 ``spikes`` dataset to an epoch file by deconvolving
    all (trial, neuron) traces on ``device`` (the reference fans a pool per
    neuron, ``compute_metrics.py:41-57``).

    ``chunk`` counts trials per dispatch (0 = auto: about 16,384 traces on
    a GPU, 512 on the CPU, where the plain version's memory sets the size).

    Crash safety: chunks append to a ``_spikes_partial_c<chunk>`` staging
    dataset that is promoted to ``spikes`` only once every trial is done, so
    a run killed mid-file resumes from the last complete chunk instead of
    leaving a silently truncated ``spikes`` dataset behind.

    Each chunk is read, uploaded, deconvolved and written in turn (the
    upload is synchronous: a chunk is 134 MB at 160 x 2048 x 102, which
    the host stages around it outweigh); the dispatch takes the chunk's
    ``(N, C, W)`` view of its NWC signals, so its spikes come back NWC.
    Returns the file's host-clock seconds by stage (``read``, ``upload``,
    ``deconvolve``, ``write``, ``total``) and, under ``<key>``, the change
    over the call of each ``oasis/<key>`` of
    :data:`~calciumgan_tpu_torch.utils.tracing.totals` that the dispatch
    added to (``kernel``, ``spikes_to_host``, ``redo`` seconds inside
    ``deconvolve``; the counts ``traces``, ``flagged``, ``bit0``-``bit2``,
    ``window_moves``);
    with ``config.verbose`` they are printed. The totals are process-wide,
    so the change is this file's alone: ``compute_metrics`` and
    ``compute_dg_metrics`` run no other dispatch meanwhile (their figures
    render in spawned processes)."""
    device = torch.device(device)
    start_all = perf_counter()
    seconds: collections.Counter = collections.Counter()
    calls = collections.Counter(tracing.calls)
    totals = collections.Counter(tracing.totals)
    if config.verbose:
        print(f"\tDeconvolve {filename}")
    n = h5.get_dataset_length(filename, "signals")
    if chunk <= 0:
        per_trial = max(1, int(getattr(config, "num_neurons", 1) or 1))
        target = (_CHUNK_TRACES_CUDA if device.type == "cuda"
                  else _CHUNK_TRACES_CPU)
        chunk = max(1, target // per_trial)
    # the chunk size rides in the staging name: the chunk-boundary
    # arithmetic below is only sound against appends of the SAME size, and
    # a resume on another device computes other chunks; mismatched
    # partials restart cleanly
    staging = f"_spikes_partial_c{chunk}"
    for stale in h5.keys(filename):
        if stale.startswith("_spikes_partial") and stale != staging:
            h5.delete(filename, stale)
    if n == 0:
        # an empty signals dataset has nothing to stage; write an empty
        # spikes dataset directly instead of promoting a never-created one
        h5.write(filename, {"spikes": np.zeros(
            (0,) + tuple(h5.get_shape(filename, "signals")[1:]), np.int8)})
        return dict(seconds)
    done = 0
    if h5.contains(filename, staging):
        # resume; unconditionally redo the LAST chunk: an HDF5 append
        # resizes before it writes, so a kill can leave a chunk-ALIGNED
        # length whose final chunk reads back as fill-value zeros
        done = max(0, (h5.get_dataset_length(filename, staging) // chunk - 1)
                   * chunk)
        h5.truncate(filename, staging, done)

    def lap(stage: str, since: float) -> float:
        now = perf_counter()
        seconds[stage] += now - since
        return now

    for start in range(done, n, chunk):
        clock = perf_counter()
        signals = h5.get(filename, "signals", start=start, stop=start + chunk)
        clock = lap("read", clock)
        # NWC -> (N, C, W), so time is the trailing axis, where they lie
        traces = torch.from_numpy(np.ascontiguousarray(signals, np.float32))
        traces = traces.to(device).permute(0, 2, 1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        clock = lap("upload", clock)
        spikes = deconvolve_traces(traces)
        clock = lap("deconvolve", clock)
        h5.write(filename, {staging: np.transpose(spikes, (0, 2, 1))})
        lap("write", clock)
    h5.rename(filename, staging, "spikes")
    for name in tracing.calls - calls:
        if name.startswith("oasis/"):
            seconds[name[len("oasis/"):]] = tracing.totals[name] - totals[name]
    seconds["total"] = perf_counter() - start_all
    if config.verbose:
        print("\t\t" + ", ".join(
            f"{k} {v}" if isinstance(v, int) else f"{k} {v:.3f} s"
            for k, v in seconds.items()))
    return dict(seconds)


def ensure_spikes(config, filename: str,
                  device="cpu") -> Optional[Dict[str, float]]:
    """Deconvolve unless a COMPLETE ``spikes`` dataset already exists; a
    short one (from a legacy run killed mid-append) is dropped and redone
    rather than silently mis-joined against ``signals``. Returns
    :func:`deconvolve_file`'s seconds, or None when nothing was to do."""
    if h5.contains(filename, "spikes"):
        if (h5.get_dataset_length(filename, "spikes")
                == h5.get_dataset_length(filename, "signals")):
            return None
        h5.delete(filename, "spikes")
    return deconvolve_file(config, filename, device=device)


# ---------------------------------------------------------------------------
# batched statistics (device side)
# ---------------------------------------------------------------------------

def _upper(matrices: torch.Tensor) -> torch.Tensor:
    """(N, C, C) -> (N, P): each matrix's upper triangle, row by row."""
    C = matrices.shape[-1]
    iu = torch.triu_indices(C, C, offset=1, device=matrices.device)
    return matrices[:, iu[0], iu[1]]


def _firing_rates_nwc(spikes_nwc: torch.Tensor) -> torch.Tensor:
    """(N, W, C) -> (N, C) rates in Hz: each spike count times the float32
    reciprocal of the duration, as XLA compiles the JAX package's jitted
    ``count / duration``. Where that reciprocal is inexact (4608 frames:
    1/192 s; 20,000 frames) the quotient of :func:`sm.mean_firing_rate`
    differs by an ulp, which moves a rate on a histogram edge and its KL."""
    duration = torch.tensor(spikes_nwc.shape[1] / sm.FRAMERATE,
                            dtype=torch.float32, device=spikes_nwc.device)
    counts = spikes_nwc.to(torch.float32).sum(dim=1)
    return counts * torch.reciprocal(duration)


def _per_trial_upper_corr(spikes_nwc: torch.Tensor) -> torch.Tensor:
    """(N, W, C) -> (N, P) upper-triangle correlation per trial."""
    return _upper(sm.correlation_coefficients(spikes_nwc.transpose(1, 2)))


def _per_trial_upper_cov(spikes_nwc: torch.Tensor) -> torch.Tensor:
    return _upper(sm.covariance(spikes_nwc.transpose(1, 2)))


def _per_trial_upper_van_rossum(spikes_nwc: torch.Tensor,
                                tau: float = 1.0) -> torch.Tensor:
    """(N, W, C) -> (N, P) upper-triangle pairwise van Rossum per trial."""
    return _upper(sm.van_rossum_distance(
        spikes_nwc.transpose(1, 2).contiguous(), tau=tau))


def _per_trial_upper_vp(spikes_nwc: torch.Tensor) -> torch.Tensor:
    """(N, W, C) -> (N, P) upper-triangle pairwise Victor-Purpura distance
    per trial, where the spikes lie."""
    return _upper(sm.victor_purpura_distance_batch(
        spikes_nwc.transpose(1, 2), device=spikes_nwc.device))


def chunked(fn, array, chunk: int = 128) -> np.ndarray:
    """Apply a per-batch tensor ``fn`` over dim 0 of ``array`` (a tensor,
    taken where it lies, or an array) in chunks of ``chunk`` rows, so the
    device's memory stays bounded; the results as one host array. (The JAX
    package pads the tail chunk to spare XLA a compile; eager PyTorch has
    no use for that.)"""
    array = torch.as_tensor(array)
    outs = [fn(array[start:start + chunk]).cpu().numpy()
            for start in range(0, len(array), chunk)]
    return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------------------
# per-metric entry points (host orchestration + plots)
# ---------------------------------------------------------------------------

def _load_spikes(config, filename: str, num_samples: int,
                 device="cpu") -> torch.Tensor:
    """Load spikes as a float32 NWC tensor on ``device`` regardless of the
    layout on disk (the surrogate path stores them neuron-major; the
    reference normalises by dim matching, ``utils.py:155-184``). Dim 0 is
    trial-major in both layouts, so the range read happens before the
    transpose."""
    spikes = np.asarray(h5.get(filename, "spikes", start=0,
                               stop=num_samples))
    spikes = np.ascontiguousarray(
        arrays.set_array_format(spikes, "NWC", config))
    return torch.from_numpy(spikes).to(device).float()


def firing_rate_metrics(config, summary, real_spikes, fake_spikes,
                        epoch: int) -> np.ndarray:
    """Per-neuron firing-rate histograms + KL
    (reference ``compute_metrics.py:195-252``)."""
    if config.verbose:
        print("\tComputing firing rate")
    real_rates = chunked(_firing_rates_nwc, real_spikes)   # (N, C)
    fake_rates = chunked(_firing_rates_nwc, fake_spikes)
    pairs = [(real_rates[:, n], fake_rates[:, n])
             for n in range(config.num_neurons)]
    summary.plot_histograms_grid(
        "firing_rate", data=[pairs[n] for n in config.neurons],
        xlabel="Hz", ylabel="Count",
        titles=[f"Neuron #{n:03d}" for n in config.neurons],
        step=epoch, legend_labels=["recorded", "synthetic"],
        plots_per_row=config.plots_per_row)
    kl = sm.pairs_kl_divergence(pairs, device=fake_spikes.device)
    summary.plot_distribution("firing_rate_kl", data=kl,
                              xlabel="KL divergence", ylabel="Count",
                              title="Firing Rate", step=epoch)
    if config.verbose:
        message = f"\t\tKL mean: {np.mean(kl):.04f}\n"
        for n in config.neurons:
            message += f"\t\tneuron {n:03d}: {kl[n]:.02f}\n"
        print(message)
    return kl


def _plot_pairs_and_kl(config, summary, pairs, epoch, tag: str, title: str,
                       xlabel: str, device) -> np.ndarray:
    """Per-trial histogram grid + KL distribution (the shared tail of every
    pairwise statistic)."""
    summary.plot_histograms_grid(
        f"{tag}", data=[pairs[i] for i in config.trials],
        xlabel=xlabel, ylabel="Count",
        titles=[f"Sample #{i:03d}" for i in config.trials],
        step=epoch, legend_labels=["recorded", "synthetic"],
        plots_per_row=config.plots_per_row)
    kl = sm.pairs_kl_divergence(pairs, device=device)
    summary.plot_distribution(f"{tag}_kl", data=kl, xlabel="KL divergence",
                              ylabel="Count", title=title, step=epoch)
    return kl


def _pairwise_metric(config, summary, real_spikes, fake_spikes, epoch,
                     device_fn, tag: str, title: str,
                     xlabel: str) -> np.ndarray:
    real = chunked(device_fn, real_spikes)  # (N, P)
    fake = chunked(device_fn, fake_spikes)
    pairs = [(arrays.remove_nan(real[i]), arrays.remove_nan(fake[i]))
             for i in range(len(real))]
    return _plot_pairs_and_kl(config, summary, pairs, epoch, tag, title,
                              xlabel, fake_spikes.device)


def correlation_metrics(config, summary, real_spikes, fake_spikes,
                        epoch: int) -> np.ndarray:
    """Per-trial binned-correlation histograms + KL
    (reference ``compute_metrics.py:308-356``)."""
    if config.verbose:
        print("\tComputing correlation coefficient")
    kl = _pairwise_metric(config, summary, real_spikes, fake_spikes, epoch,
                          _per_trial_upper_corr, "correlation", "Correlation",
                          "Correlation")
    if config.verbose:
        print(f"\t\tmean: {np.nanmean(kl):.04f}")
    return kl


def covariance_metrics(config, summary, real_spikes, fake_spikes,
                       epoch: int) -> np.ndarray:
    """Per-trial binned-covariance histograms + KL (present but disabled in
    the reference main, ``compute_metrics.py:272-304,498``)."""
    if config.verbose:
        print("\tComputing covariance")
    kl = _pairwise_metric(config, summary, real_spikes, fake_spikes, epoch,
                          _per_trial_upper_cov, "covariance_histogram",
                          "Covariance", "Covariance")
    if config.verbose:
        print(f"\t\tmin: {np.min(kl):.04f}, max: {np.max(kl):.04f}, "
              f"mean: {np.mean(kl):.04f}, "
              f"num below 1.5: {np.count_nonzero(kl < 1.5)}")
    return kl


def victor_purpura_metrics(config, summary, real_spikes, fake_spikes,
                           epoch: int) -> np.ndarray:
    """Per-trial pairwise Victor-Purpura distance KL (the reference exposes
    the statistic in ``spike_metrics.py:54-61`` but never wires it into
    compute_metrics; available here behind ``--victor_purpura``)."""
    if config.verbose:
        print("\tComputing Victor-Purpura distance")
    device = fake_spikes.device
    # trials chunked so each call carries chunk x N x N DP lanes and a
    # dense outlier only pads its own chunk; one trial at a time on the
    # CPU, where the DP rows of a larger chunk leave the cache (the JAX
    # package's sizes)
    chunk = 16 if device.type == "cuda" else 1
    real = chunked(_per_trial_upper_vp, real_spikes, chunk)
    fake = chunked(_per_trial_upper_vp, fake_spikes, chunk)
    pairs = [(arrays.remove_nan(real[i]), arrays.remove_nan(fake[i]))
             for i in range(len(real))]
    kl = _plot_pairs_and_kl(config, summary, pairs, epoch, "victor_purpura",
                            "Victor-Purpura distance",
                            "Victor-Purpura distance", device)
    if config.verbose:
        print(f"\t\tmean: {np.nanmean(kl):.04f}")
    return kl


def sort_heatmap(matrix: np.ndarray):
    """Greedy sort so the minimum lands top-left
    (reference ``compute_metrics.py:359-382``)."""
    num_trials = len(matrix)
    matrix_copy = np.copy(matrix)
    heatmap = np.full(matrix.shape, np.nan, np.float32)
    min_index = np.unravel_index(np.argmin(matrix), matrix.shape)
    row_order = np.full((num_trials,), -1, np.int64)
    row_order[0] = min_index[0]
    column_order = np.argsort(matrix[min_index[0]])
    for i in range(num_trials):
        if i != 0:
            row_order[i] = np.argsort(matrix_copy[:, column_order[i]])[0]
        heatmap[i] = matrix[row_order[i]][column_order]
        matrix_copy[row_order[i]][:] = np.inf
    return heatmap, row_order, column_order


def van_rossum_metrics(config, summary, real_spikes, fake_spikes,
                       epoch: int, heatmap_trials: int = 45) -> np.ndarray:
    """Greedy-sorted real-vs-fake distance heatmaps per focus neuron + KL of
    per-trial pairwise distances (reference
    ``compute_metrics.py:385-485``)."""
    if config.verbose:
        print("\tComputing van-rossum distance")

    # heatmaps: per selected neuron, distances between real & fake trials
    # (figure-only: skipped entirely without figures)
    if not summary.no_plots:
        k = min(heatmap_trials, len(real_spikes), len(fake_spikes))
        heatmaps, xticks, yticks, titles = [], [], [], []
        for n in config.neurons:
            D = sm.van_rossum_distance(real_spikes[:k, :, n],
                                       fake_spikes[:k, :, n]).cpu().numpy()
            heatmap, rows, cols = sort_heatmap(D)
            heatmaps.append(heatmap)
            xticks.append(rows)
            yticks.append(cols)
            titles.append(f"Neuron #{n:03d}")
        summary.plot_heatmaps_grid(
            "van_rossum", matrix=heatmaps, xlabel="synthetic trial",
            ylabel="recorded trial", xticklabels=xticks, yticklabels=yticks,
            titles=titles, step=epoch, plots_per_row=config.plots_per_row)

    kl = _pairwise_metric(config, summary, real_spikes, fake_spikes, epoch,
                          _per_trial_upper_van_rossum, "van_rossum",
                          "van-Rossum distance", "van-Rossum distance")
    if config.verbose:
        print(f"\t\tmean: {np.mean(kl):.04f}")
    return kl


# ---------------------------------------------------------------------------
# trace / raster plots
# ---------------------------------------------------------------------------

def plot_signals(config, summary, filename: str, epoch: int,
                 rng: np.random.Generator) -> None:
    """Real-vs-fake traces for one random trial with shared per-neuron ylims
    (reference ``compute_metrics.py:115-172``, without its inclusive
    randint off-by-one)."""
    trial = int(rng.integers(0, config.num_samples))
    if config.verbose:
        print(f"\tPlotting traces for trial #{trial}")

    def load(fn):
        signals = arrays.set_array_format(
            h5.get(fn, "signals", trial=trial), "CW", config)
        spikes = arrays.set_array_format(
            h5.get(fn, "spikes", trial=trial), "CW", config)
        return signals, spikes

    real_signals, real_spikes = load(config.validation_cache)
    fake_signals, fake_spikes = load(filename)
    assert real_signals.shape == fake_signals.shape
    ylims = [[min(rs.min(), fs.min()), max(rs.max(), fs.max())]
             for rs, fs in zip(real_signals, fake_signals)]

    idx = config.neurons[:config.num_neuron_plots]
    summary.plot_traces("real_traces", real_signals, real_spikes,
                        indexes=idx, ylims=ylims, step=epoch, is_real=True,
                        signal_label="recorded signal",
                        spike_label="inferred spike",
                        plots_per_row=config.plots_per_row)
    summary.plot_traces("fake_traces", fake_signals, fake_spikes,
                        indexes=idx, ylims=ylims, step=epoch, is_real=False,
                        signal_label="synthetic signal",
                        spike_label="inferred spike",
                        plots_per_row=config.plots_per_row)


def raster_plots(config, summary, filename: str, epoch: int,
                 trial: int = 100) -> None:
    trial = min(trial, config.num_samples - 1)
    if config.verbose:
        print(f"\tPlotting raster plot for trial #{trial}")
    real = arrays.set_array_format(
        h5.get(config.validation_cache, "spikes", trial=trial), "CW", config)
    fake = arrays.set_array_format(
        h5.get(filename, "spikes", trial=trial), "CW", config)
    summary.raster_plot("raster_plot", real_spikes=real, fake_spikes=fake,
                        xlabel="Time (s)", ylabel="Neuron",
                        legend_labels=["recorded", "synthetic"], step=epoch)


# ---------------------------------------------------------------------------
# per-epoch entry
# ---------------------------------------------------------------------------

def compute_epoch_spike_metrics(config, summary, filename: str, epoch: int,
                                rng: np.random.Generator,
                                with_covariance: bool = False,
                                with_victor_purpura: bool = False,
                                real_spikes=None, device="cpu",
                                seconds: Optional[dict] = None
                                ) -> Dict[str, float]:
    """Everything the reference runs per epoch file
    (``compute_metrics.py:488-502``), on ``device``. Returns the mean KL per
    statistic. ``real_spikes`` (a tensor on ``device``) may be passed in to
    amortise loading the validation cache across epochs
    (``--all_epochs``). A caller that reports where the time went passes a
    ``seconds`` dict: it gets :func:`deconvolve_file`'s entries as
    ``deconvolve/<entry>``, ``load_spikes`` and the host-clock seconds of
    each statistic under its result's name."""
    device = torch.device(device)
    seconds = {} if seconds is None else seconds
    for stage, s in (ensure_spikes(config, filename, device) or {}).items():
        seconds[f"deconvolve/{stage}"] = s
    if not summary.no_plots:
        plot_signals(config, summary, filename, epoch, rng)
        raster_plots(config, summary, filename, epoch)

    clock = perf_counter()
    if real_spikes is None:
        real_spikes = _load_spikes(config, config.validation_cache,
                                   config.num_samples, device)
    fake_spikes = _load_spikes(config, filename, config.num_samples, device)
    seconds["load_spikes"] = perf_counter() - clock

    metrics = [("firing_rate_kl", firing_rate_metrics)]
    if with_covariance:
        metrics.append(("covariance_kl", covariance_metrics))
    metrics += [("correlation_kl", correlation_metrics),
                ("van_rossum_kl", van_rossum_metrics)]
    if with_victor_purpura:
        metrics.append(("victor_purpura_kl", victor_purpura_metrics))
    results = {}
    for tag, metric in metrics:
        clock = perf_counter()
        kl = metric(config, summary, real_spikes, fake_spikes, epoch)
        results[tag] = float(np.nanmean(kl))
        seconds[tag] = perf_counter() - clock
    for tag, value in results.items():
        if np.isfinite(value):
            summary.scalar(f"spike_metrics/{tag}", value, step=epoch)
    return results
