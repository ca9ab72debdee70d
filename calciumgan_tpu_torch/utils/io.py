"""Generated-sample artefacts of a training run (counterpart of
``calciumgan_tpu/utils/io.py``).

Contract of the reference (``gan/utils/utils.py:93-113``): per saved epoch
an ``epoch{E:03d}_signals`` file of denormalised NWC float32 signals, plus
``generated/info.pkl`` mapping epoch -> {global_step, filename}, which the
metrics CLI follows. The files are ``.h5`` where ``h5py`` is installed and
``.npys`` directories otherwise
(:func:`calciumgan_tpu_torch.utils.h5.default_suffix`); ``info.pkl`` and
``config.validation_cache`` record the names, so a reader needs no rule of
its own.

In a data-parallel run each data index appends its rows to its own shard,
``epoch{E:03d}_signals<suffix>.RRR``, written by the first of its model or
time peers (which hold the same rows; a time-parallel run hands in whole
sequences, gathered from the time peers), and rank 0 alone keeps
``info.pkl`` (which names rank 0's shard, as the JAX package's does) and
the validation cache (of rank 0's share of the records),
``io.py:26-48``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from calciumgan_tpu_torch.data.pipeline import reverse_preprocessing
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import h5


def _recording_units(config, signals) -> np.ndarray:
    """Normalised model-space signals (a tensor on any device, or an array)
    -> float32 NWC host array in recording units."""
    x = reverse_preprocessing(config, torch.as_tensor(signals))
    return x.float().cpu().numpy()


def save_fake_signals(config, epoch: int, signals, append: bool = True) -> str:
    """``append=False`` on an epoch's FIRST batch: a crash-resumed run that
    re-validates an already-saved epoch must replace the file, since
    ``h5.write`` appends to existing datasets, which would silently double
    every row."""
    shard = (f".{mesh_lib.data_index():03d}"
             if mesh_lib.data_extent() > 1 else "")
    filename = os.path.join(
        config.generated_dir,
        f"epoch{epoch:03d}_signals{h5.default_suffix(config.verbose)}"
        f"{shard}")
    if not mesh_lib.writes_shard():
        return filename
    if not append:
        h5.remove(filename)
    h5.write(filename, {"signals": _recording_units(config, signals)})
    if mesh_lib.process_index() != 0:
        return filename

    info_filename = os.path.join(config.generated_dir, "info.pkl")
    info = {}
    if os.path.exists(info_filename):
        with open(info_filename, "rb") as f:
            info = pickle.load(f)
    entry = {"global_step": config.global_step, "filename": filename}
    if info.get(epoch) != entry:  # new epoch, or re-run after resume
        info[epoch] = entry
        tmp = info_filename + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(info, f)
        os.replace(tmp, info_filename)
    return filename


def load_generated_info(config) -> dict:
    """epoch -> {global_step, filename} for every saved generation epoch."""
    path = os.path.join(config.output_dir, "generated", "info.pkl")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: train with --save_generated first")
    with open(path, "rb") as f:
        return pickle.load(f)


def cache_validation_set(config, validation) -> None:
    """One-time dump of the denormalised validation set (signals float32,
    spikes int8) to ``config.validation_cache`` so the metrics CLI reads
    real data cheaply (reference ``dataset_helper.py:12-30``); rank 0's
    records in a data-parallel run, written by rank 0 alone."""
    if mesh_lib.process_index() != 0:
        return
    if config.validation_cache is None or \
            os.path.exists(config.validation_cache):
        return
    # stage + atomic rename: the batch loop appends incrementally, and a
    # run killed mid-loop must not leave a truncated cache that the
    # exists() guard above would silently reuse forever
    tmp = h5.staging_name(config.validation_cache)
    h5.remove(tmp)
    for signals, spikes in validation.batches(config.batch_size):
        h5.write(tmp, {
            "signals": _recording_units(config, np.ascontiguousarray(signals)),
            "spikes": np.asarray(spikes).astype(np.int8),
        })
    os.replace(tmp, config.validation_cache)
