"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` over a
few steady steps or batches, reduced to the device's busy seconds, the
kernels' time by name and the longest idle gaps by what the host was
doing. ``busy_seconds`` is a copy of the port's
``calciumgan_tpu_torch/train.py`` (commit 8a6615f)."""

from __future__ import annotations

import collections
from time import perf_counter

import torch

TOP = 10  # entries of each breakdown list
PROFILER_OWN = "Activity Buffer"  # the profiler's own host events


def is_annotation(event, host_names=frozenset()) -> bool:
    """Whether ``event`` marks a span (``record_function``, the harness's
    or the program's) rather than work: its kind where the profiler records
    it, else a name that a host event also has."""
    kind = getattr(event, "is_user_annotation", None)
    return bool(kind) if kind is not None else event.name in host_names


def device_work(events) -> list:
    """The device's events that are work (kernels, copies, sets), without
    the annotations that mirror a host span over the device's timeline."""
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name for e in events if e.device_type == cpu}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not is_annotation(e, host_names)]


def busy_seconds(events) -> float:
    """The seconds in which the device ran any of ``events``: the union of
    their intervals."""
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us * 1e-6


def _gaps(events, lo: float, hi: float) -> list:
    """``(start, end)`` in microseconds of each stretch of ``[lo, hi]`` in
    which no event ran."""
    gaps, reach = [], lo
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    if hi > reach:
        gaps.append((reach, hi))
    return gaps


def _host_activity(cpu_events, start: float, end: float) -> str:
    """The name of the shortest host event that covers at least half of the
    gap ``[start, end]``, else of the one that overlaps it most."""
    best, best_len, most, most_overlap = None, float("inf"), "idle", 0.0
    for e in cpu_events:
        a, b = e.time_range.start, e.time_range.end
        overlap = min(b, end) - max(a, start)
        if overlap <= 0:
            continue
        if overlap >= 0.5 * (end - start) and b - a < best_len:
            best, best_len = e.name, b - a
        if overlap > most_overlap:
            most, most_overlap = e.name, overlap
    return best or most


class Window:
    """Profiles from construction to :meth:`stop`, synchronising the device
    at both ends."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        self.device = torch.device(device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._start = perf_counter()

    def stop(self) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = perf_counter() - self._start
        self._prof.stop()
        return summarize(list(self._prof.events()), wall)


def summarize(events, wall: float) -> dict:
    """A traced window's numbers from the profiler's ``events`` and its
    wall seconds."""
    dev = device_work(events)
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and not e.name.startswith(PROFILER_OWN)]
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    gaps = []
    if dev:
        lo = min(e.time_range.start for e in cpu + dev)
        hi = max(e.time_range.end for e in cpu + dev)
        gaps = sorted(_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])
    return {
        "window_s": wall,
        "busy_s": busy_seconds(dev) if dev else 0.0,
        "kernel_seconds": dict(by_name),
        "device_ops": [[n[:120], s] for n, s in by_name.most_common(TOP)],
        "idle_gaps": [[_host_activity(cpu, a, b)[:120], (b - a) * 1e-6]
                      for a, b in gaps[:TOP]],
    }
