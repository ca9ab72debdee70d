"""Summaries to TensorBoard event files plus the reference's composite
figures (counterpart of ``calciumgan_tpu/utils/summary.py``).

Three writer modes, as the JAX package's: train to ``output_dir``,
validation to ``output_dir/validation``, and, with ``spike_metrics=True``,
the spike metrics to ``output_dir/metrics`` with a vector-plot directory
``metrics/plots``. ``log`` writes an epoch half's scalars (and the weight
statistics under ``--plot_weights``); every ``plot_*`` method renders its
figure inline, saves its PNG under ``<logdir>/plots`` (and, in metrics mode,
its vector copy) and writes it as an image summary.

``no_plots`` is true when the caller asks for it or when matplotlib is not
installed (one line says so): then no figure is rendered, no render pool
starts, and callers skip the work that only feeds figures; the scalars are
written all the same.

With ``workers=N`` figures render in a pool of N processes started with
``spawn`` (the JAX package's render pool): a worker renders through
:mod:`.plots` and never initialises CUDA, so evaluation overlaps
matplotlib with the card's work. :meth:`drain` writes every
figure rendered so far into the event files; :meth:`close` drains, shuts
the pool down and closes the files.

In a data-parallel run only rank 0 writes (``summary.py:56-60``): on every
other rank a ``Summary`` writes no file, renders no figure and reports
``no_plots``, so callers skip the work that feeds figures.
"""

from __future__ import annotations

import importlib.util
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

import numpy as np

from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import plots
from calciumgan_tpu_torch.utils.tb import EventWriter


class _NoWriter:
    """The writer of a rank that writes nothing."""

    def scalar(self, *args, **kwargs):
        pass

    histogram = image = scalar


_NO_WRITER = _NoWriter()


class Summary:

    def __init__(self, config, spike_metrics: bool = False,
                 no_plots: bool = False, workers: int = 0):
        self._config = config
        self.spike_metrics = spike_metrics
        self.dpi = getattr(config, "dpi", 120)
        self._plot_weights = getattr(config, "plot_weights", False)
        self._noop = mesh_lib.process_index() != 0
        if not no_plots and not self._noop and \
                importlib.util.find_spec("matplotlib") is None:
            print("matplotlib is not installed: figures are skipped")
            no_plots = True
        self.no_plots = no_plots or self._noop
        self._workers = max(0, int(workers))
        self._pool = None
        self._pending = []

        if self._noop:
            self._plot_weights = False
            self.profiler_dir = None
        elif spike_metrics:
            self._metrics_dir = os.path.join(config.output_dir, "metrics")
            self.format = getattr(config, "format", "pdf")
            self._vector_dir = os.path.join(self._metrics_dir, "plots")
            self.metrics_writer = EventWriter(self._metrics_dir)
            # a refresh of the KL scalars without figures must not wipe
            # the figures a previous full run rendered
            if not self.no_plots:
                if os.path.exists(self._vector_dir):
                    shutil.rmtree(self._vector_dir)
                os.makedirs(self._vector_dir)
        else:
            self.profiler_dir = os.path.join(config.output_dir, "profiler")
            self.train_writer = EventWriter(config.output_dir)
            self.val_writer = EventWriter(
                os.path.join(config.output_dir, "validation"))

    def _writers(self):
        if self._noop:
            return []
        return ([self.metrics_writer] if self.spike_metrics
                else [self.train_writer, self.val_writer])

    def _writer(self, training: bool) -> EventWriter:
        if self._noop:
            return _NO_WRITER
        if self.spike_metrics:
            return self.metrics_writer
        return self.train_writer if training else self.val_writer

    def scalar(self, tag, value, step=0, training=True):
        self._writer(training).scalar(tag, float(value), step)

    def histogram(self, tag, values, step=0, training=True):
        self._writer(training).histogram(tag, np.asarray(values), step)

    def flush(self):
        self.drain()
        for writer in self._writers():
            writer.flush()

    def drain(self):
        """Write every pending pooled figure into the event files."""
        pending, self._pending = self._pending, []
        for future, tag, step, training in pending:
            self._write_image(future.result(), tag, step, training)

    def close(self):
        """Drain pooled figures, shut the pool down, close the files."""
        try:
            self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None
        for writer in self._writers():
            writer.close()

    # ------------------------------------------------------------------
    # figures
    # ------------------------------------------------------------------
    def _meta(self, tag, step, training):
        logdir = (self._metrics_dir if self.spike_metrics else
                  (self._config.output_dir if training else
                   os.path.join(self._config.output_dir, "validation")))
        safe = tag.replace("/", "_")
        meta = {"dpi": self.dpi,
                "png_path": os.path.join(logdir, "plots",
                                         f"{safe}_step{step:06d}.png")}
        if self.spike_metrics:
            meta["vector_path"] = os.path.join(self._vector_dir,
                                               f"{safe}.{self.format}")
            meta["vector_format"] = self.format
        return meta

    def _figure(self, kind, payload, tag, step, training):
        if self.no_plots:
            return
        meta = self._meta(tag, step, training)
        if not self._workers:
            self._write_image(plots.render_and_save(kind, payload, meta),
                              tag, step, training)
            return
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                max_workers=self._workers,
                mp_context=multiprocessing.get_context("spawn"))
        self._pending.append((self._pool.submit(
            plots.render_and_save, kind, payload, meta), tag, step,
            training))

    def _write_image(self, result, tag, step, training):
        png, w, h = result
        self._writer(training).image(f"{tag}/image/0", png, height=h,
                                     width=w, step=step)

    def plot_traces(self, tag, signals, spikes, indexes, ylims=None,
                    xlabel="Time (s)", ylabel=r"$\Delta F/F$", step=0,
                    training=True, is_real=True, signal_label="signal",
                    spike_label="spike", plots_per_row=3):
        """Signal traces + spike rasters per neuron of ``(neuron, time)``
        arrays (reference ``summary_helper.py:121-206``)."""
        signals, spikes = np.asarray(signals), np.asarray(spikes)
        if signals.ndim != 2 or spikes.shape != signals.shape:
            raise ValueError(f"traces {signals.shape} and spikes "
                             f"{spikes.shape} must be (neuron, time)")
        self._figure("traces", dict(
            signals=signals, spikes=spikes, indexes=list(indexes),
            ylims=ylims, xlabel=xlabel, ylabel=ylabel, is_real=is_real,
            signal_label=signal_label, spike_label=spike_label,
            plots_per_row=plots_per_row), tag, step, training)

    def raster_plot(self, tag, real_spikes, fake_spikes, xlabel="",
                    ylabel="", legend_labels=None, step=0, training=True):
        """Joint raster with marginal histograms
        (reference ``summary_helper.py:208-315``)."""
        self._figure("raster", dict(
            real_spikes=np.asarray(real_spikes),
            fake_spikes=np.asarray(fake_spikes), xlabel=xlabel,
            ylabel=ylabel, legend_labels=legend_labels), tag, step, training)

    def plot_distribution(self, tag, data, xlabel="", ylabel="", title="",
                          bins=30, step=0, training=False):
        self._figure("distribution", dict(
            data=np.asarray(data), xlabel=xlabel, ylabel=ylabel,
            title=title, bins=bins), tag, step, training)

    def plot_histogram(self, tag, data, xlabel="", ylabel="", step=0,
                       training=False, legend_labels=None):
        """Real-vs-fake overlaid histogram over the joint range."""
        assert isinstance(data, tuple)
        self._figure("histogram", dict(
            data=tuple(np.asarray(d) for d in data), xlabel=xlabel,
            ylabel=ylabel, legend_labels=legend_labels), tag, step, training)

    def plot_histograms_grid(self, tag, data, xlabel="", ylabel="",
                             titles=None, step=0, training=False,
                             legend_labels=None, plots_per_row=3):
        assert isinstance(data, list) and isinstance(data[0], tuple)
        self._figure("histograms_grid", dict(
            data=[tuple(np.asarray(x) for x in pair) for pair in data],
            xlabel=xlabel, ylabel=ylabel, titles=titles,
            legend_labels=legend_labels, plots_per_row=plots_per_row),
            tag, step, training)

    def plot_heatmaps_grid(self, tag, matrix, xlabel="", ylabel="",
                           xticklabels=None, yticklabels=None, titles=None,
                           step=0, training=False, plots_per_row=3):
        assert isinstance(matrix, list)
        self._figure("heatmaps_grid", dict(
            matrix=[np.asarray(m) for m in matrix], xlabel=xlabel,
            ylabel=ylabel, xticklabels=xticklabels, yticklabels=yticklabels,
            titles=titles, plots_per_row=plots_per_row), tag, step, training)

    def variable_summary(self, variable, name, step=0, training=True):
        v = np.asarray(variable)
        self.scalar(f"{name}/0_mean", v.mean(), step, training)
        self.scalar(f"{name}/1_stddev", v.std(), step, training)
        self.scalar(f"{name}/2_min", v.min(), step, training)
        self.scalar(f"{name}/3_max", v.max(), step, training)
        self.histogram(name, v, step, training)

    def plot_weights(self, weights: dict, step=0, training=True):
        """Per-parameter statistics of both nets (reference
        ``summary_helper.py:542-557``): ``weights`` holds each net's whole
        parameters by name (``train.plotted_weights``)."""
        for net in ("generator", "discriminator"):
            for i, (name, p) in enumerate(weights[net].items()):
                self.variable_summary(
                    p.float().cpu().numpy(),
                    f"plots_{net}/{i + 1:02d}/{name}", step=step,
                    training=training)

    def log(self, logs: dict, elapse: Optional[float] = None,
            weights: Optional[dict] = None, step: int = 0,
            training: bool = True):
        """An epoch half's scalars (reference
        ``summary_helper.py:559-588``), and :meth:`plot_weights` of
        ``weights`` under ``--plot_weights``."""
        for tag, value in logs.items():
            self.scalar(tag, value, step=step, training=training)
        if elapse is not None:
            self.scalar("elapse", elapse, step=step, training=training)
        if weights is not None and self._plot_weights:
            self.plot_weights(weights, step=step, training=training)
        self.flush()

