"""The closed training window of a one-chip training loop, for any training
object with ``checked()`` and ``step(k)`` (:class:`h100bench.loops.train.
Trainer` and its kinds): set-up's checked and warm steps, then steps back
to back until one step past the step boundary at which the host clock has
passed ``--seconds``, each timed by CUDA events at its boundaries, then, in
a traced run, ``traced_steps`` more under the profiler. It is the window of
``loops/train2d.py``, taking the training object it runs."""

from __future__ import annotations

import statistics
import sys
from time import perf_counter, time

import torch

from h100bench import trace
from h100bench.loops import train as train_loop
from h100bench.run import forbidden_modules


def stages(started: float):
    """A ``stage(name)`` that prints set-up's progress on standard error."""
    def stage(name: str) -> None:
        print(f"setup {name} at {time() - started:.3f} s", file=sys.stderr,
              flush=True)
    return stage


def window(trainer, mix: dict, seconds: float, traced: bool,
           started: float, stage) -> dict:
    """The checked readings, then the warm steps, the window and the traced
    steps of ``trainer``, on its device."""
    readings = trainer.checked()
    stage("checked steps")
    k = mix["checked_steps"] + mix["warm_steps"]
    for j in range(mix["checked_steps"], k):
        trainer.step(j)
    cuda = trainer.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(trainer.device)
    setup_s = time() - started
    marks = [train_loop._mark(cuda)]
    t0 = perf_counter()
    n, stop = 0, False
    while not stop:  # one step past the boundary that passes ``seconds``
        stop = perf_counter() - t0 >= seconds and n >= 2
        with torch.profiler.record_function("h100bench/train_step"):
            trainer.step(k)
        k, n = k + 1, n + 1
        marks.append(train_loop._mark(cuda))
    if cuda:
        torch.cuda.synchronize(trainer.device)
    window_s = perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(trainer.device) if cuda else 0
    profiled = None
    if traced:  # steady steps after the window, under the profiler
        tracing = trace.Window(trainer.device)
        for j in range(k, k + mix["traced_steps"]):
            with torch.profiler.record_function("h100bench/train_step"):
                trainer.step(j)
        profiled = tracing.stop()
    return {
        "steps": n, "window_s": window_s, "setup_s": setup_s,
        "step_ms": [train_loop._elapsed_ms(a, b)
                    for a, b in zip(marks, marks[1:])],
        "memory_peak_bytes": peak, "trace": profiled, "readings": readings,
        "device_kind": (torch.cuda.get_device_name(trainer.device) if cuda
                        else "cpu"),
    }


def result(lead: dict, mix: dict, numbers: dict, step_flops: float) -> dict:
    """A loop's result from its window ``lead`` and its compared
    ``numbers``."""
    steps = lead["steps"]
    return {
        "attempted": steps, "failed": 0, "numbers": numbers,
        "end_to_end": {
            "train_samples_per_s": steps * mix["batch_size"]
            / lead["window_s"],
            "train_step_p90_ms": statistics.quantiles(
                lead["step_ms"], n=10, method="inclusive")[-1],
            "setup_s": lead["setup_s"]},
        "memory_peak_bytes": lead["memory_peak_bytes"],
        "device_kind": lead["device_kind"], "count": 1,
        "forbidden": forbidden_modules(),
        "context": {
            "steps": steps, "window_s": lead["window_s"],
            "step_flops": step_flops, "chips": 1, "bytes_per_step": 0.0,
            "traces": [lead["trace"]], "traced_steps": mix["traced_steps"]},
    }


def one_chip(cell: dict, device: str) -> torch.device:
    """The device of a one-chip cell's run: ``cuda:0``, or the host in the
    tests."""
    if cell["chips"] != 1 or cell["traffic_data"].get(
            "data_parallelism", 1) != 1:
        raise ValueError(f"{cell['name']}: this loop runs on one chip")
    return torch.device("cuda:0" if device == "cuda" else device)
