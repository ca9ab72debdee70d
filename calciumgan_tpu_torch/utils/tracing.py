"""Spans and counters inside the port, and the reading of a profiler's trace
(the port's own: the JAX package has no counterpart).

:func:`span` marks where the program spends its time. Every span adds its
host seconds to :data:`totals` under its name and one to :data:`calls`;
while ``torch.profiler`` runs it also opens a ``record_function`` named
``calciumgan/<name>``, which puts it on the profiler's clock, the one the
device's timeline shares. :func:`count` adds counts to :data:`totals`, and
one a call to :data:`calls`. These process-wide counters are the port's one
record of where its time went; they follow ``oasis_cuda.launches`` and
``mesh.collective_bytes``: a reader takes their change over the stretch it
wants.

The spans, by layer:

- serving (``generate.generate``): ``generate/batch`` (args: the batch
  index) over ``generate/forward``, ``generate/signals_to_host`` and the
  OASIS dispatch's ``oasis/kernel`` (one a rung, args: the depth),
  ``oasis/redo`` (args: the rows; on the card it ends when the redo has)
  and then ``oasis/spikes_to_host``, with the counts ``oasis/traces``,
  ``oasis/flagged``, ``oasis/bit0``-``bit2`` and ``oasis/window_moves``
  (ring slots moved between the kernel's windows and its rings); the
  crossings to the host (:mod:`~calciumgan_tpu_torch.utils.crossing`)
  count ``to_host/bytes`` and ``to_host/pinned_bytes`` (those by DMA into
  page-locked memory) wherever they run;
- the train step (``WGAN_GP.train_step``): ``step`` (args: the generator's
  update count) over ``step/critic`` (one a critic iteration, the
  update left out), ``step/penalty`` inside it, ``step/generator``,
  ``step/update`` (each Adam step), ``step/ema`` and ``step/metrics``;
  ``collective/all_reduce`` where ``mesh.gradient_mean`` runs one;
- the train loop: ``data/gather`` (``DeviceStore.batch``) and
  ``data/wait`` (``DevicePrefetcher``'s queue);
- the layers (``models/base.py``): the counts ``conv/``,
  ``conv_transpose1d/`` and ``conv_transpose2d/products`` and
  ``work_products`` (what a layer's route multiplies, and the layer's own
  work: without a convolution's zero taps, a 1-D transposed convolution's
  cropped frames or the zeros of a dilated input) and ``conv/pad_bytes``
  (what a convolution that pads asymmetrically copies to pad).

:func:`device_work`, :func:`busy_seconds` and :func:`span_device_seconds`
read a finished profile's events: the device's work without the
annotations that mirror spans over its timeline, the union of its
intervals, and the device seconds under each span.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from time import perf_counter

import torch

PREFIX = "calciumgan/"  # of every span's name in a profiler's trace

# host seconds of each span by name, and the counts of :func:`count`
totals: collections.Counter = collections.Counter()
# spans closed and calls of :func:`count`, by name
calls: collections.Counter = collections.Counter()


@contextlib.contextmanager
def span(name: str, **args):
    """Time the block as the span ``name``: its host seconds go to
    :data:`totals`, and one to :data:`calls`. While a profiler runs, the
    block is also the ``record_function`` ``calciumgan/<name>`` with
    ``args`` (the batch or step it serves) as its argument string."""
    record = None
    if torch.autograd._profiler_enabled():
        record = torch.profiler.record_function(
            PREFIX + name, ",".join(f"{k}={v}" for k, v in args.items())
            or None)
        record.__enter__()
    begin = perf_counter()
    try:
        yield
    finally:
        seconds = perf_counter() - begin
        if record is not None:
            record.__exit__(None, None, None)
        totals[name] += seconds
        calls[name] += 1


def count(prefix: str, **counts: int) -> None:
    """Add ``counts`` to :data:`totals` as ``<prefix>/<key>``, and one to
    :data:`calls` under each of those names."""
    for key, n in counts.items():
        totals[f"{prefix}/{key}"] += n
        calls[f"{prefix}/{key}"] += 1


# ---------------------------------------------------------------------------
# reading a finished profile
# ---------------------------------------------------------------------------

def _is_annotation(event, host_names) -> bool:
    """Whether ``event`` marks a span (a ``record_function``, the program's
    or a caller's) rather than work: its kind where the profiler records
    it, else a name that a host event also has."""
    kind = getattr(event, "is_user_annotation", None)
    return bool(kind) if kind is not None else event.name in host_names


def device_work(events) -> list:
    """The device's events that are work (kernels, copies, sets) among a
    finished profile's ``events``, without the annotations that mirror a
    host span over the device's timeline."""
    host_names = {e.name for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not _is_annotation(e, host_names)]


def _union_us(intervals) -> float:
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def busy_seconds(events) -> float:
    """The seconds in which the device ran any of ``events``: the union of
    their intervals."""
    return _union_us((e.time_range.start, e.time_range.end)
                     for e in events) * 1e-6


def span_device_seconds(events) -> dict:
    """``{span name: device seconds}`` of a finished profile's ``events``:
    for each span, the union of the device's work launched while the span
    was open on the host, from any thread (the autograd engine runs a
    backward's launches on a thread of its own). A kernel's launch is the
    runtime call (``cuda*``, ``cu*``) that shares its correlation id.
    Nested spans each count their own work (``step/penalty``'s is
    ``step/critic``'s too). The profiler's device-side annotations are not
    read: each holds only the kernels its span launched itself, on its own
    thread, outside any inner span."""
    cpu = torch.autograd.DeviceType.CPU
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    opened = collections.defaultdict(list)
    for e in events:
        if e.device_type == cpu and e.name.startswith(PREFIX):
            opened[e.name[len(PREFIX):]].append(
                (e.time_range.start, e.time_range.end))
    work = [(launched[e.id], e.time_range.start, e.time_range.end)
            for e in device_work(events) if e.id in launched]
    out = {}
    for name, spans in sorted(opened.items()):
        spans.sort()
        starts = [a for a, _ in spans]
        pieces = []
        for t, a, b in work:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                pieces.append((a, b))
        if pieces:
            out[name] = _union_us(pieces) * 1e-6
    return out
