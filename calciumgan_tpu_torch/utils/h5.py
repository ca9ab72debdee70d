"""HDF5 output with the reference's NWC storage contract: a copy of
``write`` from the JAX package's ``calciumgan_tpu/utils/h5.py``.

Datasets are stored NWC (trial, time, neuron) and ``write`` appends when the
dataset exists. ``h5py`` is imported on use: only the serving CLI writes h5,
and the library core runs without it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def write(filename: str, content: Dict[str, np.ndarray]) -> None:
    """Write or append arrays keyed by dataset name (NWC format)."""
    import h5py
    assert isinstance(content, dict)
    with h5py.File(filename, mode="a") as f:
        for name, value in content.items():
            value = np.asarray(value)
            if name in f:
                ds = f[name]
                ds.resize(ds.shape[0] + value.shape[0], axis=0)
                ds[-value.shape[0]:] = value
            else:
                f.create_dataset(
                    name, shape=value.shape, dtype=value.dtype, data=value,
                    chunks=True, maxshape=(None,) + value.shape[1:])
