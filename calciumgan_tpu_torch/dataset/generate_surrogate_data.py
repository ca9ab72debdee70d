"""Generate the 2-neuron toy-DG surrogate datasets (counterpart of
``dataset/generate_surrogate_data.py`` at the repo root; same flags, and
``--device cuda|cpu``).

    python -m calciumgan_tpu_torch.dataset.generate_surrogate_data \\
        --output_dir surrogate --device cuda

Hard-coded mean [0.6, 0.8] and covariance [[1, .3], [.3, 1]]; three pickles
under ``--output_dir`` (wiped first): ``surrogate.pkl`` and
``ground_truth.pkl`` with ``spikes`` (num_samples, 2, sequence_length), and
``training.pkl`` with ``--training_size`` rows of the ground truth and their
AR(1) ``signals``. The spikes are drawn 100,000 sequences at a time on
``--device`` (default ``cuda``; ``cuda`` without a card raises). ``python -m
calciumgan_tpu_torch.main --model mlp --input_dir <output_dir>`` trains on
``training.pkl`` (a directory whose name holds ``surrogate`` is read as
one).
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil

import numpy as np
import torch

from calciumgan_tpu_torch.ops.dg import DichotGauss, SeededNormals
from calciumgan_tpu_torch.ops.oasis import ar1_filter
from calciumgan_tpu_torch.utils.device import resolve_device


def generate_dg_spikes(args, sampler, draws, stream: str, num_samples: int,
                       batch: int = 100_000) -> np.ndarray:
    """(num_samples, num_neurons, sequence_length) binary spike tensor."""
    out = np.zeros((num_samples, args.num_neurons, args.sequence_length),
                   np.float32)
    for i in range(0, num_samples, batch):
        n = min(batch, num_samples - i)
        # timebins = sequence_length, repeats = n samples
        eps = draws.normal(stream, (n, args.sequence_length,
                                    args.num_neurons))
        spikes = sampler.sample(eps=eps)           # (seq, n, neurons)
        out[i:i + n] = spikes.permute(1, 2, 0).cpu().numpy()
    return out


def spikes_to_signals(spikes, draws, device, g=(0.95,), sn=0.3,
                      b=0.0) -> np.ndarray:
    calcium = ar1_filter(torch.from_numpy(spikes.astype(np.float32)).to(
        device), g=g, axis=-1)
    noise = draws.normal("noise", spikes.shape)
    return (b + calcium + sn * noise).cpu().numpy().astype(np.float32)


def run(args, draws=None) -> None:
    """Write the three pickles. ``draws`` (default: seeded generators on
    ``--device``) gives the normals of the streams ``surrogate``,
    ``ground_truth`` (one call per batch) and ``noise``."""
    device = resolve_device(args.device)
    if draws is None:
        draws = SeededNormals(
            args.seed, ("surrogate", "ground_truth", "noise"), device)
    if os.path.exists(args.output_dir):
        shutil.rmtree(args.output_dir)
    os.makedirs(args.output_dir)
    surrogate_path = os.path.join(args.output_dir, "surrogate.pkl")
    ground_truth_path = os.path.join(args.output_dir, "ground_truth.pkl")
    training_path = os.path.join(args.output_dir, "training.pkl")

    args.num_neurons = 2
    mean = np.array([[0.6, 0.8]], np.float32)
    covariance = np.array([[1.0, 0.3], [0.3, 1.0]], np.float32)
    # mean is per-timebin: broadcast to sequence_length timebins
    mean_t = np.repeat(mean, args.sequence_length, axis=0)
    sampler = DichotGauss(args.num_neurons, mean=mean_t, corr=covariance,
                          make_pd=True)

    surrogate = generate_dg_spikes(args, sampler, draws, "surrogate",
                                   args.num_samples)
    print(f"save surrogate dataset to {surrogate_path}")
    with open(surrogate_path, "wb") as f:
        pickle.dump({"spikes": surrogate}, f)

    ground_truth = generate_dg_spikes(args, sampler, draws, "ground_truth",
                                      args.num_samples)
    with open(ground_truth_path, "wb") as f:
        pickle.dump({"spikes": ground_truth}, f)

    rng = np.random.default_rng(args.seed)
    indices = rng.choice(len(ground_truth), size=args.training_size)
    training_spikes = ground_truth[indices]
    training_signals = spikes_to_signals(training_spikes, draws, device)
    with open(training_path, "wb") as f:
        pickle.dump({"spikes": training_spikes,
                     "signals": training_signals}, f)
    print(f"save training dataset to {training_path}")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the sampler and the AR synthesis run")
    parser.add_argument("--output_dir", default="surrogate", type=str)
    parser.add_argument("--num_samples", default=2 * 10**6, type=int)
    parser.add_argument("--training_size", default=9192, type=int)
    parser.add_argument("--sequence_length", default=6, type=int)
    parser.add_argument("--seed", default=1234, type=int)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
