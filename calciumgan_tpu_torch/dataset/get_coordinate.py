"""Extract ROI pixel coordinates from a .mat (HDF5, v7.3) recording
(counterpart of ``dataset/get_coordinate.py`` at the repo root).

    python -m calciumgan_tpu_torch.dataset.get_coordinate \\
        --filename raw_data/MC_20181117_P01.mat --out coordinates.pkl

The recording stores a ``data`` table of HDF5 object references, one per
ROI, each pointing to a group with an ``mnCoordinates`` dataset. The first
two ROIs are skipped: the same two neurons the preprocessing drops
everywhere else. Host only; ``h5py`` is imported on use.
"""

import argparse
import pickle

SKIP_ROIS = 2  # dropped neurons, see generate_tfrecords


def roi_coordinates(filename: str, skip: int = SKIP_ROIS) -> list:
    """List of per-ROI ``mnCoordinates`` arrays from a v7.3 .mat file."""
    import h5py
    with h5py.File(filename, "r") as f:
        refs = [row[0] for row in f["data"][()][skip:]]
        return [f[ref]["mnCoordinates"][()] for ref in refs]


def main(args) -> list:
    try:
        coords = roi_coordinates(args.filename)
    except FileNotFoundError:
        raise SystemExit(f"file {args.filename} does not exists")
    for i, c in enumerate(coords):
        print(f"ROI {i + SKIP_ROIS:03d}: {c.shape[0]} points")
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(coords, f)
        print(f"saved {len(coords)} ROI coordinate arrays to {args.out}")
    else:
        print(coords)
    return coords


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filename", default="raw_data/MC_20181117_P01.mat",
                        type=str)
    parser.add_argument("--out", default="", type=str,
                        help="optional pickle output for the coordinates")
    return parser.parse_args(argv)


def cli(argv=None) -> list:
    return main(parse_args(argv))


if __name__ == "__main__":
    cli()
