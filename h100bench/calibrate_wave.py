"""The readings that ``wavegan-train``'s limits are set from, on the chip at
the cell's own size:

    python3 -m h100bench.calibrate_wave --workload wavegan-train \\
        --seeds 12 --controls 3

One JSON line a reading on standard output, as :mod:`h100bench.calibrate2d`
prints them: ``program`` (the checked steps of a sound run of the program
on each of ``--seeds`` seeds, against the reference), and on the first
``--controls`` seeds ``control_fp8`` (the reference with fp8 products in
the program's place), ``fault_half_batch`` (the reference over half the
batch) and ``fault_state_unchanged``. Each line carries the seconds its
reference took. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from time import perf_counter

import torch

from h100bench import registry, run
from h100bench.calibrate import SEED_BASE
from h100bench.calibrate2d import _readings
from h100bench.loops import trainwave
from h100bench.reference import model as ref_model


def training(cell: dict, seeds: list, controls: list, device) -> None:
    cfg, mix = cell["config_data"], cell["traffic_data"]
    readings = []
    for s in seeds:
        trainer = trainwave.WaveTrainer(cfg, mix, s, device)
        readings.append(trainer.checked())
        del trainer
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def reference(s, **kw):
        begin = perf_counter()
        out = trainwave.reference_readings(cfg, mix, s, device, **kw)
        return out, perf_counter() - begin

    for s, prog in zip(seeds, readings):
        ref, seconds = reference(s)
        _readings("program", s, prog, ref, reference_s=seconds)
        if s not in controls:
            continue
        fp8, seconds = reference(s, cast=ref_model.fp8_cast)
        _readings("control_fp8", s, fp8, ref, reference_s=seconds)
        half, seconds = reference(s, rows=mix["batch_size"] // 2)
        _readings("fault_half_batch", s, half, ref, reference_s=seconds)
        frozen = dict(ref, change={k: 0.0 for k in ref["change"]})
        _readings("fault_state_unchanged", s, frozen, ref)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="wavegan-train")
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
    training(cell, seeds, seeds[:args.controls], torch.device("cuda:0"))
    print(json.dumps({"kind": "device",
                      "name": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
