"""Dataset files with the reference's NWC storage contract (counterpart of
``calciumgan_tpu/utils/h5.py``): the same functions over two containers.

Datasets are stored NWC (trial, time, neuron); ``write`` appends when the
dataset exists; ``get`` slices per neuron, per trial or by a row range
without loading the rest.

The container is chosen by the file's name, and by nothing else:

- a name ending in ``.npys`` (or ``.npys.RRR``, a data-parallel rank's
  shard) is a directory that holds one ``<dataset>.npy`` per dataset. It
  needs numpy alone. A dataset grows in place: ``write`` puts the new rows
  behind the old ones and then rewrites the (fixed-size) header with the
  new length, so a run killed between the two leaves the
  old, complete dataset;
- any other name (``.h5``) is an HDF5 file through ``h5py``, imported on
  use, in the JAX package's layout, so either package reads the other's
  files. Without ``h5py`` such a name raises ``ImportError``.

:func:`default_suffix` names the container a writer should pick on this
installation: ``.h5`` where ``h5py`` is installed, else ``.npys``.
"""

from __future__ import annotations

import importlib.util
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np

NPY_SUFFIX = ".npys"
# bytes of a dataset's .npy header, padding included: room for any shape
_HEADER_BYTES = 256
_announced = False


def have_h5py() -> bool:
    return importlib.util.find_spec("h5py") is not None


def default_suffix(verbose: bool = True) -> str:
    """``.h5`` where ``h5py`` is installed, else ``.npys``; the first call
    prints one line saying which."""
    global _announced
    suffix = ".h5" if have_h5py() else NPY_SUFFIX
    if verbose and not _announced:
        _announced = True
        print("dataset files: " + (
            "HDF5 (.h5, h5py)" if suffix == ".h5" else
            "h5py is not installed: directories of .npy arrays (.npys)"))
    return suffix


def is_npy(filename: str) -> bool:
    return re.search(r"\.npys(\.\d{3})?$", str(filename)) is not None


def staging_name(filename: str) -> str:
    """``<root>.tmp<suffix>``: a sibling of ``filename`` in its container."""
    root, suffix = os.path.splitext(filename)
    return root + ".tmp" + suffix


def remove(filename: str) -> None:
    """Delete a dataset file of either container if it exists."""
    if os.path.isdir(filename):
        shutil.rmtree(filename)
    elif os.path.exists(filename):
        os.remove(filename)


# ---------------------------------------------------------------------------
# the numpy container
# ---------------------------------------------------------------------------

def _npy_path(filename: str, name: str) -> str:
    return os.path.join(filename, name + ".npy")


def _npy_header(shape, dtype) -> bytes:
    """A version 1.0 ``.npy`` header of ``_HEADER_BYTES`` bytes."""
    descr = np.lib.format.dtype_to_descr(np.dtype(dtype))
    text = (f"{{'descr': {descr!r}, 'fortran_order': False, "
            f"'shape': {tuple(int(s) for s in shape)!r}, }}")
    room = _HEADER_BYTES - 10 - 1  # magic, version, length; the newline
    if len(text) > room:
        raise ValueError(f"dataset header too long: {text}")
    text = text + " " * (room - len(text)) + "\n"
    return (b"\x93NUMPY\x01\x00" + (len(text)).to_bytes(2, "little")
            + text.encode("latin1"))


def _npy_meta(path: str):
    """``(shape, dtype, data offset)`` of one dataset, from its header."""
    with open(path, "rb") as f:
        np.lib.format.read_magic(f)
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        if fortran:
            raise ValueError(f"{path}: Fortran order")
        return tuple(shape), dtype, f.tell()


def _npy_rows(path: str, start=None, stop=None) -> np.ndarray:
    """Rows ``start:stop`` of a dataset as an array in memory."""
    shape, dtype, offset = _npy_meta(path)
    lo, hi, _ = slice(start, stop).indices(shape[0])
    rows = max(0, hi - lo)
    if rows == 0 or not all(shape[1:]):
        return np.zeros((rows,) + shape[1:], dtype)
    row_items = int(np.prod(shape[1:], dtype=np.int64))
    with open(path, "rb") as f:
        f.seek(offset + lo * row_items * dtype.itemsize)
        flat = np.fromfile(f, dtype, rows * row_items)
    return flat.reshape((rows,) + shape[1:])


def _npy_view(path: str) -> np.ndarray:
    """A read-only memory map of a dataset (no empty dims)."""
    shape, dtype, offset = _npy_meta(path)
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape)


def _npy_create(path: str, value: np.ndarray) -> None:
    value = np.ascontiguousarray(value)
    with open(path, "wb") as f:
        f.write(_npy_header(value.shape, value.dtype))
        value.tofile(f)


def _npy_resize(path: str, length: int) -> None:
    """Set a dataset's row count (the rows must be in the file)."""
    shape, dtype, offset = _npy_meta(path)
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
    with open(path, "r+b") as f:
        f.write(_npy_header((length,) + shape[1:], dtype))
        f.truncate(offset + length * row_bytes)


def _npy_append(path: str, value: np.ndarray) -> None:
    shape, dtype, offset = _npy_meta(path)
    value = np.ascontiguousarray(value, dtype)
    if value.shape[1:] != shape[1:]:
        raise ValueError(f"cannot append {value.shape} to {shape}")
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
    with open(path, "r+b") as f:
        # behind the rows the header counts (not at the end of the file: a
        # killed append may have left rows the header never got to count)
        f.seek(offset + shape[0] * row_bytes)
        value.tofile(f)
        f.truncate()
        f.flush()
        f.seek(0)
        f.write(_npy_header((shape[0] + len(value),) + shape[1:], dtype))


def _npy_require(filename: str, name: str) -> str:
    path = _npy_path(filename, name)
    if not os.path.exists(path):
        raise KeyError(f"no dataset '{name}' in {filename}")
    return path


# ---------------------------------------------------------------------------
# the functions of calciumgan_tpu/utils/h5.py
# ---------------------------------------------------------------------------

def append(ds, value: np.ndarray) -> None:
    """Append rows to an open ``h5py`` dataset."""
    ds.resize(ds.shape[0] + value.shape[0], axis=0)
    ds[-value.shape[0]:] = value


def write(filename: str, content: Dict[str, np.ndarray]) -> None:
    """Write or append arrays keyed by dataset name (NWC format)."""
    assert isinstance(content, dict)
    if is_npy(filename):
        os.makedirs(filename, exist_ok=True)
        for name, value in content.items():
            path = _npy_path(filename, name)
            if os.path.exists(path):
                _npy_append(path, np.asarray(value))
            else:
                _npy_create(path, np.asarray(value))
        return
    import h5py
    with h5py.File(filename, mode="a") as f:
        for name, value in content.items():
            value = np.asarray(value)
            if name in f:
                append(f[name], value)
            else:
                f.create_dataset(
                    name, shape=value.shape, dtype=value.dtype, data=value,
                    chunks=True, maxshape=(None,) + value.shape[1:])


def overwrite(filename: str, name: str, value: np.ndarray) -> None:
    if is_npy(filename):
        _npy_create(_npy_require(filename, name), np.asarray(value))
        return
    import h5py
    with h5py.File(filename, mode="r+") as f:
        if name not in f:
            raise KeyError(f"no dataset '{name}' in {filename}")
        del f[name]
        f.create_dataset(name, shape=value.shape, dtype=value.dtype,
                         data=value)


def delete(filename: str, name: str) -> None:
    """Drop a dataset if present (no-op when absent)."""
    if is_npy(filename):
        path = _npy_path(filename, name)
        if os.path.exists(path):
            os.remove(path)
        return
    import h5py
    with h5py.File(filename, mode="r+") as f:
        if name in f:
            del f[name]


def truncate(filename: str, name: str, length: int) -> None:
    """Shrink a resizable dataset to ``length`` rows along dim 0."""
    if is_npy(filename):
        path = _npy_require(filename, name)
        if length < _npy_meta(path)[0][0]:
            _npy_resize(path, length)
        return
    import h5py
    with h5py.File(filename, mode="r+") as f:
        ds = f[name]
        if length < ds.shape[0]:
            ds.resize(length, axis=0)


def rename(filename: str, src: str, dst: str) -> None:
    """Move ``src`` to ``dst`` inside the file, replacing any existing
    ``dst`` (used to promote a complete staging dataset in one step)."""
    if is_npy(filename):
        os.replace(_npy_require(filename, src), _npy_path(filename, dst))
        return
    import h5py
    with h5py.File(filename, mode="r+") as f:
        if dst in f:
            del f[dst]
        f.move(src, dst)


def get(filename: str, name: str, neuron: Optional[int] = None,
        trial: Optional[int] = None, start: Optional[int] = None,
        stop: Optional[int] = None) -> np.ndarray:
    """Read a dataset; ``neuron`` slices NWC -> (N, W), ``trial`` -> (W, C),
    ``start``/``stop`` range-read dim 0 without loading the rest."""
    assert not (neuron is not None and trial is not None)
    if is_npy(filename):
        path = _npy_require(filename, name)
        if neuron is not None:
            if not all(_npy_meta(path)[0]):
                return _npy_rows(path)[:, :, neuron]
            return np.array(_npy_view(path)[:, :, neuron])
        if trial is not None:
            return _npy_rows(path, trial, trial + 1 or None)[0]
        return _npy_rows(path, start, stop)
    import h5py
    with h5py.File(filename, mode="r") as f:
        if name not in f:
            raise KeyError(f"no dataset '{name}' in {filename}")
        ds = f[name]
        if neuron is not None:
            return ds[:, :, neuron]
        if trial is not None:
            return ds[trial, :, :]
        if start is not None or stop is not None:
            return ds[start:stop]
        return ds[:]


def get_shape(filename: str, name: str) -> tuple:
    """Dataset shape from metadata only (no data read)."""
    if is_npy(filename):
        return _npy_meta(_npy_require(filename, name))[0]
    import h5py
    with h5py.File(filename, "r") as f:
        return tuple(f[name].shape)


def get_dataset_length(filename: str, name: str) -> int:
    return get_shape(filename, name)[0]


def keys(filename: str) -> list:
    """Top-level dataset names (empty when the file does not exist)."""
    if not os.path.exists(filename):
        return []
    if is_npy(filename):
        return sorted(n[:-4] for n in os.listdir(filename)
                      if n.endswith(".npy"))
    import h5py
    with h5py.File(filename, "r") as f:
        return list(f.keys())


def contains(filename: str, name: str) -> bool:
    if is_npy(filename):
        if not os.path.isdir(filename):
            raise FileNotFoundError(filename)
        return os.path.exists(_npy_path(filename, name))
    import h5py
    with h5py.File(filename, mode="r") as f:
        return name in f
