"""Fit a DG model to a recorded pickle and sample a synthetic recording
(counterpart of ``dataset/generate_dg_data.py`` at the repo root; same
flags, and ``--device cuda|cpu``).

    python -m calciumgan_tpu_torch.dataset.generate_dg_data \\
        --input raw_data/data.pkl --output dg/data.pkl --device cuda

Drops the first 2 neurons of the pickle's ``oasis`` spike trains, fits the
inverse-normal mean and the fixed-rate covariance, samples spike trains of
the same duration from the Dichotomized Gaussian, turns spikes into calcium
with the AR(1) recurrence plus Gaussian noise (sn = 0.3), and saves
``{signals, oasis, mean, covariance}``. The sampler and the AR synthesis are
tensor programs on ``--device`` (default ``cuda``; ``cuda`` without a card
raises): :class:`calciumgan_tpu_torch.ops.dg.DichotGauss` and
:func:`calciumgan_tpu_torch.ops.oasis.ar1_filter`. ``python -m
calciumgan_tpu_torch.dataset.generate_tfrecords --is_dg_data`` segments the
result.
"""

from __future__ import annotations

import argparse
import os
import pickle
from time import perf_counter

import numpy as np
import torch

from calciumgan_tpu_torch.ops.dg import (DGOptimise, DichotGauss,
                                         SeededNormals)
from calciumgan_tpu_torch.ops.oasis import ar1_filter
from calciumgan_tpu_torch.utils.device import resolve_device


def get_recorded_data_statistics(args):
    if not os.path.exists(args.input):
        print(f"Input {args.input} does not exists")
        raise SystemExit(1)
    with open(args.input, "rb") as f:
        data = pickle.load(f)

    spike_trains = np.asarray(data["oasis"], np.float32)[2:]
    args.num_neurons = spike_trains.shape[0]
    args.duration = spike_trains.shape[1]

    # (timebins=1, trials=duration, neurons)
    spike_trains = np.expand_dims(np.transpose(spike_trains), axis=0)
    dg_optimizer = DGOptimise(spike_trains)

    print("measuring mean...")
    mean = dg_optimizer.gauss_mean
    print("measuring covariance...")
    covariance = dg_optimizer.data_tfix_covariance
    return mean, covariance


def generate_dg_spikes(args, mean, corr, draws):
    """``(spikes (neurons, duration) float32 on the host, whether the
    covariance went through the Higham projection)``."""
    print("sample spike trains")
    sampler = DichotGauss(args.num_neurons, mean=mean, corr=corr,
                          make_pd=True)
    eps = draws.normal("sample", (args.duration, 1, args.num_neurons))
    spikes = sampler.sample(eps=eps)
    # (1, duration, neurons) -> (neurons, duration)
    return (np.ascontiguousarray(spikes[0].T.cpu().numpy(), np.float32),
            sampler.projected)


def spikes_to_signals(args, spike_trains, draws, device, g=(0.95,), sn=0.3,
                      b=0.0):
    """AR(1) synthesis + noise, on ``device``."""
    print("transformation from spikes to signals")
    calcium = ar1_filter(torch.from_numpy(spike_trains).to(device), g=g,
                         axis=-1)
    noise = draws.normal("noise", (args.num_neurons, args.duration))
    return (b + calcium + sn * noise).cpu().numpy().astype(np.float32)


def run(args, draws=None, seconds=None) -> dict:
    """Write ``args.output``. ``draws`` (default: a
    :class:`~calciumgan_tpu_torch.ops.dg.SeededNormals` of ``--seed`` on
    ``--device``) gives the normals of the streams ``sample`` and
    ``noise``; a ``seconds`` dict gets the host seconds of ``fit``,
    ``sample``, ``filter`` and ``write``. Returns the pickle's dictionary
    and ``projected`` (whether a singular covariance sent the sampler
    through the Higham projection)."""
    device = resolve_device(args.device)
    if draws is None:
        draws = SeededNormals(args.seed, ("sample", "noise"), device)
    seconds = {} if seconds is None else seconds
    clock = perf_counter()

    def lap(stage: str) -> None:
        nonlocal clock
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = perf_counter()
        seconds[stage], clock = now - clock, now

    mean, covariance = get_recorded_data_statistics(args)
    lap("fit")
    dg_spikes, projected = generate_dg_spikes(args, mean, covariance, draws)
    lap("sample")
    dg_signals = spikes_to_signals(args, dg_spikes, draws, device)
    lap("filter")

    if os.path.exists(args.output):
        os.remove(args.output)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    data = {"signals": dg_signals, "oasis": dg_spikes, "mean": mean,
            "covariance": covariance}
    with open(args.output, "wb") as f:
        pickle.dump(data, f)
    lap("write")
    if projected:
        print("the covariance was not positive definite: sampled from its "
              "Higham projection")
    print(f"Saved {len(dg_signals)} DG signals and spikes to {args.output}")
    return dict(data, projected=projected)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the sampler and the AR synthesis run")
    parser.add_argument("--input",
                        default="raw_data/ST260_Day4_signals4Bryan.pkl")
    parser.add_argument("--output", default="dg/data.pkl")
    parser.add_argument("--seed", default=1234, type=int)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
