"""Infer spike trains for raw calcium recordings with OASIS AR(1) on the GPU
(counterpart of ``dataset/spike_train_inference.py`` at the repo root).

    python -m calciumgan_tpu_torch.dataset.spike_train_inference \\
        --input_dir raw_data --device cuda

Per pickle in ``--input_dir`` (sorted), deconvolves the whole ``(neurons,
T)`` matrix ``signals`` with g=0.95, s_min=0.55, binarised at 0.5, and stores
the spikes under ``oasis`` as float32 of the same shape; a file that already
has ``oasis`` is skipped unless ``--overwrite``, and ``--clean`` removes the
key. The signals go to ``--device`` once per file; whole recordings (more
than 4096 frames) run the long OASIS kernel there, with flagged traces
recomputed in float64 on the host
(:func:`calciumgan_tpu_torch.ops.oasis.deconvolve_signals_host`).
``--device cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import os
import pickle
from glob import glob

import numpy as np
import torch

from calciumgan_tpu_torch.eval.spike_eval import deconvolve_traces


def generate_spike_train(filename: str, device: torch.device,
                         overwrite: bool = False) -> None:
    print(f"processing file {filename}...")
    with open(filename, "rb") as f:
        data = pickle.load(f)
    if "oasis" in data:
        print(f"oasis spike train already existed in {filename}")
        if not overwrite:
            return
        print("overwriting...")
    signals = torch.from_numpy(np.ascontiguousarray(data["signals"],
                                                    np.float32)).to(device)
    data["oasis"] = deconvolve_traces(signals).astype(np.float32)
    with open(filename, "wb") as f:
        pickle.dump(data, f)


def remove_oasis(filename: str) -> None:
    print(f"cleaning file {filename}...")
    with open(filename, "rb") as f:
        data = pickle.load(f)
    if "oasis" in data:
        del data["oasis"]
        with open(filename, "wb") as f:
            pickle.dump(data, f)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", default="raw_data", type=str)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the OASIS kernel runs")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--clean", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu "
                           "to run on the host)")
    device = torch.device(args.device)
    for filename in sorted(glob(os.path.join(args.input_dir, "*.pkl"))):
        if args.clean:
            remove_oasis(filename)
        else:
            generate_spike_train(filename, device, args.overwrite)
    print("process completed")


if __name__ == "__main__":
    main()
