"""Run one cell of the benchmark once, on the GPUs of this machine:

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration, traffic
mix and chips (:mod:`h100bench.registry`); the mix's ``loop`` names the
loop that drives the program (``h100bench/loops/<loop>.py``). With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each read by
``metrics/<metric>.py`` from what the run counted and traced. Every run
holds what it served or trained to the reference (:mod:`h100bench.compare`)
and prints each compared number beside its limit, last on standard error
and last in the result's line.

Without CUDA, or with fewer GPUs than the cell asks for, it exits with 2
and prints no result: it never falls back to the CPU. A run that loaded
the JAX package or its stack (``FORBIDDEN``), in this process or in any
rank it started, exits with 3 and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from h100bench import compare, registry

# modules of the JAX package and its stack, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "calciumgan_tpu")


def process_start() -> float:
    """This process's start, seconds since the epoch."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """The forbidden top-level names in this process's ``sys.modules``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", default=0, type=int, choices=(0, 1))
    return parser.parse_args(argv)


def cache_dirs() -> None:
    """Every compiler cache inside the checkout, at fixed paths."""
    base = registry.ROOT / "build" / "h100bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def result_line(cell: dict, result: dict, traced: bool,
                root=registry.ROOT) -> dict:
    """The printed result of a finished loop: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
    and ``checks`` last."""
    correct, checks = compare.judge(result["numbers"],
                                    registry.limits(cell["name"], root))
    metrics = {}
    if traced:
        ctx = dict(result["context"], cell=cell["name"])
        for m in registry.metrics_for("per_layer", cell["name"], root):
            value = registry.reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # "<quantity>.<cells>" is the loop's <quantity> under a bound of
        # those cells' own
        for m in registry.metrics_for("end_to_end", cell["name"], root):
            value = result["end_to_end"][m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": result["device_kind"],
              "count": result["count"],
              "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": correct and result["failed"] == 0,
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device}
    traces = [t for t in result["context"]["traces"] if t]
    if traced and traces:
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        line["breakdown"] = {"device_ops": traces[0]["device_ops"],
                             "idle_gaps": traces[0]["idle_gaps"]}
    line["checks"] = checks
    return line


def report(cell: dict, result: dict, traced: bool,
           root=registry.ROOT) -> int:
    """Print the run's compared numbers on standard error and its result
    line last on standard output; 0. Where this process, or a rank the loop
    started (its ``forbidden``), loaded the JAX package or its stack, name
    it on standard error and print no result: 3."""
    line = result_line(cell, result, traced, root)
    found = sorted(set(forbidden_modules()) | set(result.get("forbidden",
                                                              ())))
    if found:
        print(f"the run loaded {found}, which the port may not use",
              file=sys.stderr)
        return 3
    for name, value in result["numbers"].items():
        if name not in line["checks"]:
            print(f"reading {name}: {value!r} (not compared)",
                  file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    started = process_start()
    args = parse_args(argv)
    cache_dirs()
    cell = registry.cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    loop = importlib.import_module(
        f"h100bench.loops.{cell['traffic_data']['loop']}")
    result = loop.run(cell, args.seed, args.seconds, bool(args.trace),
                      started)
    return report(cell, result, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
