"""The figures of training and of the spike metrics (copy of the renderers
and ``render_and_save`` of ``calciumgan_tpu/utils/plots.py``), rendered
inline or in :mod:`.summary`'s spawned render pool, whose workers import
this module alone.

matplotlib is imported when the first figure is rendered, not with this
module: the port's library core and a machine without matplotlib import it
too. The object-oriented API (no pyplot), so no global figure state.
"""

from __future__ import annotations

import io
import os
import struct
import warnings
from typing import Any, Dict, Tuple

import numpy as np

REAL_COLOR = "dodgerblue"
FAKE_COLOR = "orangered"
FRAMERATE = 24  # Hz, reference summary_helper.py:66


def _figure(figsize):
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    matplotlib.rcParams.update({
        "xtick.labelsize": 12, "ytick.labelsize": 12,
        "legend.fontsize": 12, "axes.titlesize": 14, "axes.labelsize": 14})
    fig = Figure(figsize=figsize)
    FigureCanvasAgg(fig)
    fig.patch.set_facecolor("white")
    return fig


def _despine(ax) -> None:
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)


def _render_traces(p: Dict[str, Any]):
    """Signal traces + spike rasters per neuron
    (reference ``summary_helper.py:121-206``)."""
    signals, spikes = np.asarray(p["signals"]), np.asarray(p["spikes"])
    indexes, ylims = p["indexes"], p.get("ylims")
    plots_per_row = p.get("plots_per_row", 3)
    num_rows = -(-len(indexes) // plots_per_row)
    fig = _figure((5 * plots_per_row, 2.5 * num_rows))
    color = REAL_COLOR if p.get("is_real", True) else FAKE_COLOR

    for i, neuron in enumerate(indexes):
        ax = fig.add_subplot(num_rows, plots_per_row, i + 1)
        ax.plot(signals[neuron], label=p.get("signal_label", "signal"),
                linewidth=1, alpha=0.6, color=color)
        ticks = np.arange(0, signals.shape[1], 200)
        ax.set_xticks(ticks)
        ax.set_xticklabels(ticks // FRAMERATE)
        x = np.nonzero(spikes[neuron])[0]
        fill = (ylims[neuron][0] +
                (ylims[neuron][1] - ylims[neuron][0]) * 0.1
                if ylims else 0)
        ax.scatter(x, np.full(x.shape, fill), s=100, marker="|",
                   linewidth=1.5, label=p.get("spike_label", "spike"),
                   color="dimgray")
        if i == 0:
            ax.legend(loc="upper right", ncol=1, frameon=False)
        ax.set_title(f"Neuron #{neuron:03d}")
        if i == len(indexes) - 1:
            ax.set_xlabel(p.get("xlabel", "Time (s)"))
        ax.set_ylabel(p.get("ylabel", r"$\Delta F/F$"))
        if ylims:
            ax.set_ylim(ylims[neuron])
        _despine(ax)
    return fig


def _render_raster(p: Dict[str, Any]):
    """Joint raster (trial x time scatter) with marginal histograms
    (parity: ``summary_helper.py:208-315``), via a matplotlib gridspec
    instead of the deprecated seaborn JointGrid API."""
    real_x, real_y = np.nonzero(np.asarray(p["real_spikes"]))
    fake_x, fake_y = np.nonzero(np.asarray(p["fake_spikes"]))

    fig = _figure((9, 7))
    gs = fig.add_gridspec(2, 2, width_ratios=(8, 1), height_ratios=(1, 8),
                          hspace=0.05, wspace=0.05)
    ax = fig.add_subplot(gs[1, 0])
    ax_mx = fig.add_subplot(gs[0, 0], sharex=ax)
    ax_my = fig.add_subplot(gs[1, 1], sharey=ax)

    ax.scatter(real_y, real_x, color=REAL_COLOR, marker="|",
               linewidth=1.5, alpha=0.7, s=40)
    ax.scatter(fake_y, fake_x, color=FAKE_COLOR, marker="|",
               linewidth=1.5, alpha=0.7, s=40)
    ax.set_xlabel(p.get("xlabel", ""))
    ax.set_ylabel(p.get("ylabel", ""))
    ax.set_ylim([-2, 104])
    ticks = np.asarray(ax.get_xticks())
    ax.set_xticks(ticks)  # fix the locator before relabelling
    ax.set_xticklabels((ticks // FRAMERATE).astype(np.int64))

    def marg(axm, real, fake, vertical):
        if real.size + fake.size == 0:
            return
        kw = dict(bins=25, alpha=0.6, rwidth=0.85,
                  orientation="horizontal" if vertical else "vertical")
        axm.hist(real, color=REAL_COLOR, **kw)
        axm.hist(fake, color=FAKE_COLOR, **kw)
        axm.axis("off")

    marg(ax_mx, real_y, fake_y, vertical=False)
    marg(ax_my, real_x, fake_x, vertical=True)

    if p.get("legend_labels") is not None:
        ax.legend(labels=p["legend_labels"], ncol=2, frameon=True,
                  loc=(0.02, 0.95), fancybox=True, framealpha=1)
    return fig


def _render_distribution(p: Dict[str, Any]):
    fig = _figure((5, 4))
    ax = fig.add_subplot(111)
    values = np.asarray(p["data"]).ravel()
    values = values[np.isfinite(values)]
    if values.size:
        ax.hist(values, bins=p.get("bins", 30), rwidth=0.85, color="green")
    ax.set_xlabel(p.get("xlabel", ""))
    ax.set_ylabel(p.get("ylabel", ""))
    if p.get("title"):
        ax.set_title(p["title"])
    _despine(ax)
    return fig


def _render_histogram(p: Dict[str, Any]):
    """Real-vs-fake overlaid histogram over the joint range (the reference
    took both ends from ``data[0]``, ``summary_helper.py:360-366``)."""
    data = p["data"]
    fig = _figure((12, 10))
    ax = fig.add_subplot(111)
    lo = min(np.min(data[0]), np.min(data[1]))
    hi = max(np.max(data[0]), np.max(data[1]))
    kw = dict(bins=30, range=(lo, hi), rwidth=0.85, alpha=0.6)
    ax.hist(data[0], color=REAL_COLOR, label="Real", **kw)
    ax.hist(data[1], color=FAKE_COLOR, label="Fake", **kw)
    if p.get("legend_labels") is not None:
        ax.legend(labels=p["legend_labels"])
    ax.set_xlabel(p.get("xlabel", ""))
    ax.set_ylabel(p.get("ylabel", ""))
    _despine(ax)
    return fig


def _render_histograms_grid(p: Dict[str, Any]):
    data = p["data"]
    plots_per_row = p.get("plots_per_row", 3)
    titles = p.get("titles")
    num_rows = -(-len(data) // plots_per_row)
    fig = _figure((5 * plots_per_row, 5 * num_rows))
    for i, (real, fake) in enumerate(data):
        ax = fig.add_subplot(num_rows, plots_per_row, i + 1)
        real, fake = np.asarray(real), np.asarray(fake)
        if real.size and fake.size:
            lo = min(np.min(real), np.min(fake))
            hi = max(np.max(real), np.max(fake))
            kw = dict(bins=30, range=(lo, hi), rwidth=0.85, alpha=0.6)
            ax.hist(real, color=REAL_COLOR, label="Real", **kw)
            ax.hist(fake, color=FAKE_COLOR, label="Fake", **kw)
        if i == 0 and p.get("legend_labels") is not None:
            ax.legend(labels=p["legend_labels"], frameon=False)
        ax.set_ylabel(p.get("ylabel", ""))
        if titles is not None:
            ax.set_title(titles[i])
        if i // plots_per_row == num_rows - 1:
            ax.set_xlabel(p.get("xlabel", ""))
        _despine(ax)
    return fig


def _render_heatmaps_grid(p: Dict[str, Any]):
    matrix = p["matrix"]
    plots_per_row = p.get("plots_per_row", 3)
    titles = p.get("titles")
    xticklabels, yticklabels = p.get("xticklabels"), p.get("yticklabels")
    num_rows = -(-len(matrix) // plots_per_row)
    fig = _figure((5 * plots_per_row, 5 * num_rows))
    vmax = float(np.max([np.max(m) for m in matrix]))
    for i, m in enumerate(matrix):
        ax = fig.add_subplot(num_rows, plots_per_row, i + 1)
        im = ax.imshow(m, cmap="YlOrRd", vmin=0, vmax=vmax, aspect="auto")
        fig.colorbar(im, ax=ax)
        ax.set_xlabel(p.get("xlabel", ""))
        ax.set_ylabel(p.get("ylabel", ""))
        if titles is not None:
            ax.set_title(titles[i])
        if isinstance(xticklabels, list):
            ticks = list(range(0, len(xticklabels[i]), 2))
            ax.set_xticks(ticks)
            ax.set_xticklabels([xticklabels[i][t] for t in ticks],
                               fontsize=12)
        if isinstance(yticklabels, list):
            ticks = list(range(0, len(yticklabels[i]), 2))
            ax.set_yticks(ticks)
            ax.set_yticklabels([yticklabels[i][t] for t in ticks],
                               fontsize=12)
    return fig


RENDERERS = {
    "traces": _render_traces,
    "raster": _render_raster,
    "distribution": _render_distribution,
    "histogram": _render_histogram,
    "histograms_grid": _render_histograms_grid,
    "heatmaps_grid": _render_heatmaps_grid,
}




def render_and_save(kind: str, payload: Dict[str, Any],
                    meta: Dict[str, Any]) -> Tuple[bytes, int, int]:
    """Build the figure ``kind`` (a key of ``RENDERERS``), save its PNG to
    ``meta["png_path"]`` and its vector copy to ``meta["vector_path"]`` (in
    ``meta["vector_format"]``) when given, and return ``(png_bytes, width,
    height)`` for the event file. Raises ``ImportError`` without
    matplotlib."""
    fig = RENDERERS[kind](payload)
    with warnings.catch_warnings():
        # gridspec figures (the raster plot) are not tight_layout-compatible
        warnings.simplefilter("ignore", UserWarning)
        fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, dpi=90, format="png", facecolor="white")
    png = buf.getvalue()
    w, h = struct.unpack(">II", png[16:24])  # the PNG's IHDR chunk
    if meta.get("png_path"):
        os.makedirs(os.path.dirname(meta["png_path"]), exist_ok=True)
        fig.savefig(meta["png_path"], dpi=meta["dpi"], format="png",
                    facecolor="white")
    if meta.get("vector_path"):
        fig.savefig(meta["vector_path"], dpi=meta["dpi"],
                    format=meta["vector_format"])
    return png, w, h
