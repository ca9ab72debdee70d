"""Generate synthetic calcium signals from a trained checkpoint on the GPU
(serving; counterpart of ``generate.py`` at the repo root).

    python -m calciumgan_tpu_torch.generate --output_dir runs/001 \\
        --num_samples 100000 --spikes

Restores the generator (the EMA when the run kept one, with the
generator's BatchNorm running statistics) from the newest checkpoint under
``<output_dir>/checkpoints``: the port's own
``epoch-NNN.pt`` or the JAX package's ``epoch-NNN.msgpack``
(:func:`~calciumgan_tpu_torch.utils.checkpoint.restore_generator_params`),
generates on ``--device`` (default ``cuda``) and writes denormalised NWC
float32 signals to the dataset ``signals`` of ``--out`` (HDF5, or a
``.npys`` directory of ``.npy`` arrays where the name ends so:
:mod:`calciumgan_tpu_torch.utils.h5`), with OASIS spikes as int8
``spikes`` under ``--spikes``. The CLI is one process on one device.

Called inside a data-parallel group of P ranks, :func:`generate` draws each
global batch (``batch_size`` rounded up to a multiple of P) on every rank
and generates only the rank's block of its rows, and :func:`main` writes
them to the shard ``<out>.RRR`` (``generate.py:53-75``): the shards' rows,
put back together batch by batch, are the one-process output of the same
seed and batch.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator

import numpy as np
import torch

from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.algorithms import gan
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data.pipeline import reverse_preprocessing
from calciumgan_tpu_torch.eval.spike_eval import deconvolve_traces
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import crossing, tracing
from calciumgan_tpu_torch.utils.checkpoint import restore_generator_params


def build_generator(config, variables, device) -> torch.nn.Module:
    """The configured generator on ``device`` with Flax ``variables``
    (``{"params": ..., "batch_stats": ...}``): its parameters and its
    BatchNorm running statistics, all of which it must take."""
    generator, _ = get_models(config, device=device)
    generator.load_state_dict(convert.generator_state_dict(
        variables["params"], config.model, variables.get("batch_stats")))
    return generator


def generate(config, variables, num_samples: int, batch_size: int = 1024,
             with_spikes: bool = False, seed: int = 0,
             device="cuda") -> Iterator[dict]:
    """Yield one payload per batch until ``num_samples`` rows: ``signals``
    ``(n, T, C)`` float32 in recording units and, ``with_spikes``, int8
    ``spikes`` of the same shape, both C-contiguous host numpy arrays that
    the caller owns: no later batch writes to them. On a CUDA device they
    lie in page-locked host memory (:mod:`~calciumgan_tpu_torch.utils.
    crossing`), which torch's caching host allocator takes back for a later
    batch once the caller drops them.

    Noise is drawn ``batch_size`` rows at a time from a ``torch.Generator``
    on ``device`` seeded with ``seed``. On a CUDA device float32 layers
    follow torch's TF32 switches, which the caller sets (:func:`main` turns
    both off). In a group of P ranks each batch is drawn whole and the
    rank's block of its rows generated (the last batch's rows past
    ``num_samples`` dropped, so a rank may yield fewer).

    Each batch runs as the span ``generate/batch``, closed before its
    payload is yielded, over ``generate/forward``, ``generate/
    signals_to_host`` (twice: the copy issued, and waited for) and the
    OASIS dispatch's spans (:mod:`~calciumgan_tpu_torch.utils.tracing`)."""
    device = torch.device(device)
    generator = build_generator(config, variables, device)
    rng = torch.Generator(device=device).manual_seed(seed)
    # the signals cross to the host on a stream of their own
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    rank, world = mesh_lib.process_index(), mesh_lib.process_count()
    batch_size = -(-batch_size // world) * world
    local = batch_size // world
    written = index = 0
    while written < num_samples:
        n = min(batch_size, num_samples - written)
        written += n
        lo, hi = rank * local, min((rank + 1) * local, n)
        if hi <= lo:  # the last batch holds no row of this rank
            return
        with tracing.span("generate/batch", batch=index):
            with tracing.span("generate/forward"):
                noise = gan.get_noise(rng, batch_size, config.noise_dim,
                                      device)
                fake = gan.generate(generator,
                                    mesh_lib.rows_of(noise, rank, world))
                signals = reverse_preprocessing(config, fake)[:hi - lo].float()
            with tracing.span("generate/signals_to_host"):
                pending = crossing.start(signals, side)  # runs under OASIS
            spikes = None
            if with_spikes:
                # (n, C, T) traces; the spikes come back laid out as the
                # signals, (n, T, C), so this transpose is a view
                spikes = np.transpose(
                    deconvolve_traces(signals.transpose(1, 2)), (0, 2, 1))
            with tracing.span("generate/signals_to_host"):
                payload = {"signals": pending.wait()}
            if with_spikes:
                payload["spikes"] = spikes
        index += 1
        yield payload
        # the caller holds what it keeps: the host blocks of the rest go
        # back to the caching allocator for the next batch
        del payload, pending, spikes


def main(config, num_samples: int, out: str, batch_size: int = 1024,
         with_spikes: bool = False, epoch=None, seed: int = 0,
         device="cuda") -> str:
    from calciumgan_tpu_torch.utils import h5  # h5py only for a .h5 name

    # float32 layers in full float32, not TF32, on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.load()  # hparams.json of the training run
    config.validate_model_shapes()
    ckpt_dir = config.ckpt_dir or os.path.join(config.output_dir,
                                               "checkpoints")
    variables, restored_epoch = restore_generator_params(
        ckpt_dir, epoch=epoch, ema=float(config.ema or 0.0) > 0.0,
        model=config.model)
    if config.verbose:
        print(f"Restored checkpoint epoch {restored_epoch} from {ckpt_dir}")
    if mesh_lib.process_count() > 1:  # each rank writes its own rows
        out = f"{out}.{mesh_lib.process_index():03d}"
    h5.remove(out)
    written = 0
    for payload in generate(config, variables, num_samples, batch_size,
                            with_spikes, seed, device):
        h5.write(out, payload)
        written += len(payload["signals"])
        if config.verbose:
            print(f"\r{written}/{num_samples}", end="", flush=True)
    if config.verbose:
        print(f"\nsaved {written} samples (epoch {restored_epoch} "
              f"checkpoint) to {out}")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", default="runs", type=str,
                        help="training run directory (hparams + checkpoints)")
    parser.add_argument("--num_samples", default=10000, type=int)
    parser.add_argument("--batch_size", default=1024, type=int)
    parser.add_argument("--out", default="", type=str,
                        help="output file (default <output_dir>/samples.h5); "
                             "a name ending in .npys is written as a "
                             "directory of .npy arrays, without h5py")
    parser.add_argument("--spikes", action="store_true",
                        help="also deconvolve spikes (OASIS)")
    parser.add_argument("--epoch", default=None, type=int,
                        help="checkpoint epoch (default: latest)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--ema", default=argparse.SUPPRESS, type=float,
                        help="override the run's --ema at generation time "
                             "(--ema 0 samples the raw generator of an "
                             "EMA-trained checkpoint)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to generate on")
    parser.add_argument("--verbose", default=1, type=int)
    return parser.parse_args(argv)


def cli(argv=None) -> str:
    args = parse_args(argv)
    config = Config(output_dir=args.output_dir, verbose=args.verbose)
    if hasattr(args, "ema"):
        config.ema = args.ema
        config._explicit.add("ema")
    return main(config, num_samples=args.num_samples,
                out=args.out or os.path.join(args.output_dir, "samples.h5"),
                batch_size=args.batch_size, with_spikes=args.spikes,
                epoch=args.epoch, seed=args.seed, device=args.device)


if __name__ == "__main__":
    cli()
