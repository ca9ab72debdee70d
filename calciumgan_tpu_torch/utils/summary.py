"""Training summaries to TensorBoard event files (counterpart of the
training half of ``calciumgan_tpu/utils/summary.py``).

Two writers, as the JAX package's: train to ``output_dir``, validation to
``output_dir/validation``. ``log`` writes an epoch half's scalars (and the
weight statistics under ``--plot_weights``); ``plot_traces`` renders the
trace figure inline, saves its PNG under ``<logdir>/plots`` and writes it
as an image summary. Without matplotlib the figures are skipped, with one
line saying so; the scalars are written all the same.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from calciumgan_tpu_torch.utils import plots
from calciumgan_tpu_torch.utils.tb import EventWriter


class Summary:

    def __init__(self, config):
        self._config = config
        self.dpi = getattr(config, "dpi", 120)
        self._plot_weights = getattr(config, "plot_weights", False)
        self._figures = True  # until matplotlib turns out to be missing
        self.profiler_dir = os.path.join(config.output_dir, "profiler")
        self.train_writer = EventWriter(config.output_dir)
        self.val_writer = EventWriter(
            os.path.join(config.output_dir, "validation"))

    def _writer(self, training: bool) -> EventWriter:
        return self.train_writer if training else self.val_writer

    def scalar(self, tag, value, step=0, training=True):
        self._writer(training).scalar(tag, float(value), step)

    def histogram(self, tag, values, step=0, training=True):
        self._writer(training).histogram(tag, np.asarray(values), step)

    def flush(self):
        self.train_writer.flush()
        self.val_writer.flush()

    def close(self):
        self.train_writer.close()
        self.val_writer.close()

    def plot_traces(self, tag, signals, spikes, indexes, ylims=None,
                    xlabel="Time (s)", ylabel=r"$\Delta F/F$", step=0,
                    training=True, is_real=True, signal_label="signal",
                    spike_label="spike", plots_per_row=3):
        """Signal traces + spike rasters per neuron of ``(neuron, time)``
        arrays (reference ``summary_helper.py:121-206``)."""
        if not self._figures:
            return
        signals, spikes = np.asarray(signals), np.asarray(spikes)
        if signals.ndim != 2 or spikes.shape != signals.shape:
            raise ValueError(f"traces {signals.shape} and spikes "
                             f"{spikes.shape} must be (neuron, time)")
        logdir = (self._config.output_dir if training else
                  os.path.join(self._config.output_dir, "validation"))
        meta = {"dpi": self.dpi,
                "png_path": os.path.join(
                    logdir, "plots",
                    f"{tag.replace('/', '_')}_step{step:06d}.png")}
        payload = dict(signals=signals, spikes=spikes, indexes=list(indexes),
                       ylims=ylims, xlabel=xlabel, ylabel=ylabel,
                       is_real=is_real, signal_label=signal_label,
                       spike_label=spike_label, plots_per_row=plots_per_row)
        try:
            png, w, h = plots.render_traces(payload, meta)
        except ImportError:
            self._figures = False
            print("matplotlib is not installed: figures are skipped")
            return
        self._writer(training).image(f"{tag}/image/0", png, height=h,
                                     width=w, step=step)

    def variable_summary(self, variable, name, step=0, training=True):
        v = np.asarray(variable)
        self.scalar(f"{name}/0_mean", v.mean(), step, training)
        self.scalar(f"{name}/1_stddev", v.std(), step, training)
        self.scalar(f"{name}/2_min", v.min(), step, training)
        self.scalar(f"{name}/3_max", v.max(), step, training)
        self.histogram(name, v, step, training)

    def plot_weights(self, state, step=0, training=True):
        """Per-parameter statistics of both nets
        (reference ``summary_helper.py:542-557``)."""
        for prefix, net in (("plots_generator", state.generator),
                            ("plots_discriminator", state.discriminator)):
            for i, (name, p) in enumerate(net.module.named_parameters()):
                self.variable_summary(
                    p.detach().float().cpu().numpy(),
                    f"{prefix}/{i + 1:02d}/{name}", step=step,
                    training=training)

    def log(self, logs: dict, elapse: Optional[float] = None, state=None,
            step: int = 0, training: bool = True):
        """An epoch half's scalars (reference
        ``summary_helper.py:559-588``)."""
        for tag, value in logs.items():
            self.scalar(tag, value, step=step, training=training)
        if elapse is not None:
            self.scalar("elapse", elapse, step=step, training=training)
        if state is not None and self._plot_weights:
            self.plot_weights(state, step=step, training=training)
        self.flush()

