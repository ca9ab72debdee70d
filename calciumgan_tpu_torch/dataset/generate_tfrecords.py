"""Segment a recording pickle into sharded TFRecord files + info.pkl
(counterpart of ``dataset/generate_tfrecords.py`` at the repo root; same
flags and the same bytes on disk).

    python -m calciumgan_tpu_torch.dataset.generate_tfrecords \\
        --input raw_data/data.pkl --output_dir dataset/tfrecords \\
        --sequence_length 2048 --stride 2 --normalize

The pickle holds ``signals`` and ``oasis`` (neurons, T), the latter written
by ``python -m calciumgan_tpu_torch.dataset.spike_train_inference``.
Segmentation, FFT and normalisation are
:mod:`calciumgan_tpu_torch.data.segments` (numpy, on the host); the records
go through :mod:`calciumgan_tpu_torch.data.tfrecord`, byte-compatible with
``tf.data`` readers. ``python -m calciumgan_tpu_torch.main`` trains on the
result.
"""

import argparse
import os
import pickle

from calciumgan_tpu_torch.data import segments


def main(args) -> None:
    if not os.path.exists(args.input):
        print(f"input file {args.input} does not exists")
        raise SystemExit(1)
    if os.path.exists(args.output_dir):
        if args.replace:
            import shutil
            shutil.rmtree(args.output_dir)
        else:
            print(f"output directory {args.output_dir} already exists, "
                  f"use --replace to overwrite")
            raise SystemExit(1)

    with open(args.input, "rb") as f:
        data = pickle.load(f)

    signals, spikes, meta = segments.preprocess(
        data, sequence_length=args.sequence_length, stride=args.stride,
        apply_fft=args.fft, conv2d=args.conv2d, do_normalize=args.normalize,
        is_dg_data=args.is_dg_data, fft_norm=args.fft_norm)

    info = segments.write_dataset(
        args.output_dir, signals, spikes, meta,
        sequence_length=args.sequence_length, stride=args.stride,
        validation_size=args.validation_size, do_normalize=args.normalize,
        apply_fft=args.fft, conv2d=args.conv2d,
        target_shard_size=args.target_shard_size, verbose=args.verbose,
        fft_norm=args.fft_norm)

    print(f"saved {info['train_size']} train + {info['validation_size']} "
          f"validation segments to {args.output_dir}")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", default="raw_data/data.pkl", type=str)
    parser.add_argument("--output_dir", default="tfrecords", type=str)
    parser.add_argument("--sequence_length", default=2048, type=int)
    parser.add_argument("--stride", default=2, type=int)
    parser.add_argument("--normalize", action="store_true")
    parser.add_argument("--fft", action="store_true")
    parser.add_argument("--fft_norm", default="global",
                        choices=["global", "per_channel"],
                        help="min-max statistics for --fft data: 'global' "
                             "(reference semantics, one scalar pair over "
                             "all coefficients) or 'per_channel' (one pair "
                             "per coefficient position)")
    parser.add_argument("--conv2d", action="store_true")
    parser.add_argument("--replace", action="store_true")
    parser.add_argument("--validation_size", default=1000, type=int)
    parser.add_argument("--is_dg_data", action="store_true")
    parser.add_argument("--target_shard_size", default=0.5, type=float,
                        help="approximate shard size in GB")
    parser.add_argument("--verbose", default=1, type=int)
    return parser.parse_args(argv)


def cli(argv=None) -> None:
    main(parse_args(argv))


if __name__ == "__main__":
    cli()
