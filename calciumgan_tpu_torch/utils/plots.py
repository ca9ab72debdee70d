"""The trace figure of training (copy of ``_render_traces`` and
``render_and_save`` in ``calciumgan_tpu/utils/plots.py``).

matplotlib is imported when the first figure is rendered, not with this
module: the port's library core and a machine without matplotlib import it
too. The object-oriented API (no pyplot), so no global figure state.
"""

from __future__ import annotations

import io
import os
import struct
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
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    return fig


def render_traces(payload: Dict[str, Any],
                  meta: Dict[str, Any]) -> Tuple[bytes, int, int]:
    """Render the trace figure; save its PNG to ``meta["png_path"]`` when
    given; return ``(png_bytes, width, height)`` for the event file.
    Raises ``ImportError`` without matplotlib."""
    fig = _render_traces(payload)
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, dpi=90, format="png", facecolor="white")
    png = buf.getvalue()
    w, h = struct.unpack(">II", png[16:24])  # the PNG's IHDR chunk
    if meta.get("png_path"):
        os.makedirs(os.path.dirname(meta["png_path"]), exist_ok=True)
        fig.savefig(meta["png_path"], dpi=meta["dpi"], format="png",
                    facecolor="white")
    return png, w, h
