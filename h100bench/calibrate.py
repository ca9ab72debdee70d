"""The readings that a cell's limits are set from, on the chip at the
cell's own size:

    python3 -m h100bench.calibrate --workload <cell> --seeds 12 \\
        --controls 3

One JSON line a reading on standard output: ``program`` (a sound run of
the program on each of ``--seeds`` seeds: the checked steps of a training
cell, or a short window of served batches, as many rows compared as a run
compares), ``control`` (the reference computed a precision below the
configuration's, put in the program's place) and each fault a cell can
have, on ``--controls`` seeds. ``PERF.md`` gives the readings and the
limits set between them. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from h100bench import compare, registry, run
from h100bench.loops import generate as gen_loop
from h100bench.loops import train as train_loop
from h100bench.reference import model as ref_model

SEED_BASE = 7_000_000_000


def _emit(kind: str, seed: int, numbers: dict, **extra) -> None:
    print(json.dumps({"kind": kind, "seed": seed, **numbers, **extra}),
          flush=True)


def no_exchange(algo) -> None:
    """The fault "the exchange between chips left out": each rank applies
    its own gradients."""
    from calciumgan_tpu_torch.parallel import mesh
    mesh.gradient_mean = list


def _rank_readings(cell, seeds, fault=None) -> list:
    """Per seed, every rank's readings of the checked steps."""
    from calciumgan_tpu_torch.parallel import launch
    cfg, mix = cell["config_data"], cell["traffic_data"]
    devices = [f"cuda:{i}" for i in range(cell["chips"])]
    if len(devices) == 1:
        return [[r] for r in train_loop.checked_readings(cfg, mix, seeds,
                                                          devices, fault)]
    ranks = launch.launch(train_loop.checked_readings, devices, "nccl",
                          args=(cfg, mix, seeds, devices, fault))
    return [list(per_seed) for per_seed in zip(*ranks)]


def _worst(readings: list, ref: dict) -> dict:
    numbers = {}
    for r in readings:
        for name, value in compare.training_numbers(r, ref).items():
            numbers[name] = max(numbers.get(name, 0.0), value)
    return numbers


def training(cell: dict, seeds: list, controls: list, device) -> None:
    cfg, mix = cell["config_data"], cell["traffic_data"]
    program_readings = _rank_readings(cell, seeds)
    faulty = (_rank_readings(cell, controls, no_exchange)
              if cell["chips"] > 1 else [])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for s, readings in zip(seeds, program_readings):
        ref = train_loop.reference_readings(cfg, mix, s, device)
        _emit("program", s, _worst(readings, ref))
    for s, readings in zip(controls, faulty):
        ref = train_loop.reference_readings(cfg, mix, s, device)
        _emit("fault_no_exchange", s, _worst(readings, ref))
    for s in controls:
        ref = train_loop.reference_readings(cfg, mix, s, device)
        fp8 = train_loop.reference_readings(cfg, mix, s, device,
                                            cast=ref_model.fp8_cast)
        _emit("control_fp8", s, compare.training_numbers(fp8, ref))
        half = train_loop.reference_readings(cfg, mix, s, device,
                                             rows=mix["batch_size"] // 2)
        _emit("fault_half_batch", s, compare.training_numbers(half, ref))
        frozen = dict(ref, change={k: 0.0 for k in ref["change"]})
        _emit("fault_state_unchanged", s,
              compare.training_numbers(frozen, ref))


def serving(cell: dict, seeds: list, controls: list, device) -> None:
    from calciumgan_tpu_torch.ops import oasis, oasis_cuda
    cfg = cell["config_data"]
    mix = dict(cell["traffic_data"], kept_rows_per_batch=max(
        cell["traffic_data"]["kept_rows_per_batch"],
        -(-cell["traffic_data"]["checked_rows"] // 4)))
    cell = dict(cell, traffic_data=mix)
    for s in seeds:
        result = gen_loop.run(cell, s, 0.0, False, time.time())
        _emit("program", s, result["numbers"])
    o, T = cfg["oasis"], cfg["sequence_length"]
    for s in controls:
        gen_w = gen_loop.served_weights(cfg, device)
        g = torch.Generator(device=device).manual_seed(s)
        z = torch.randn((mix["checked_rows"], cfg["noise_dim"]),
                        generator=g, device=device)
        ref = gen_loop.reference_signals(cfg, gen_w, z)
        fp8 = gen_loop.reference_signals(cfg, gen_w, z, ref_model.fp8_cast)
        truth = gen_loop.reference_spikes(cfg, fp8).cpu().numpy()
        f32 = gen_loop.reference_spikes(cfg, fp8, torch.float32)
        _emit("control_fp8_f32", s, compare.generate_numbers(
            fp8.cpu().numpy(), ref.cpu().numpy(), f32.cpu().numpy(), truth))
        # the program's own float32 path: the kernel's first rung, no redo
        traces = fp8.transpose(1, 2).reshape(-1, T).contiguous()
        long = T > oasis_cuda.PALLAS_MAX_T
        entry = oasis_cuda.oasis_ar1_long if long else oasis_cuda.oasis_ar1
        depth = (oasis._long_ladder(T) if long else oasis._DEPTH_LADDER)[0]
        _, spk, redo = entry(traces, g=o["g"], lam=0.0, s_min=o["s_min"],
                             depth=depth, merge_attempts=oasis._MERGE_BUDGET,
                             precise=long,
                             flag_tol=oasis._flag_tol(o["s_min"],
                                                      o["threshold"], long))
        kernel = (spk > o["threshold"]).reshape(
            fp8.shape[0], fp8.shape[2], T).transpose(1, 2)
        _emit("control_kernel_no_redo", s, compare.generate_numbers(
            fp8.cpu().numpy(), ref.cpu().numpy(), kernel.cpu().numpy(),
            truth), flagged=int(redo.count_nonzero()),
            traces=int(redo.numel()))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default=12, type=int)
    parser.add_argument("--controls", default=3, type=int)
    parser.add_argument("--first", default=SEED_BASE, type=int)
    args = parser.parse_args(argv)
    run.cache_dirs()
    if not torch.cuda.is_available():
        print("calibration runs on the chip", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    controls = seeds[:args.controls]
    device = torch.device("cuda:0")
    kind = cell["traffic_data"]["loop"]
    (training if kind == "train" else serving)(cell, seeds, controls, device)
    print(json.dumps({"kind": "device",
                      "name": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
