"""Input pipeline (counterpart of ``calciumgan_tpu/data/pipeline.py``):
dataset loading, batches on the device, and reverse preprocessing.

Shards are decoded once into contiguous numpy arrays (cached as ``.npy``
beside the records, the names the JAX package uses, so either package reads
the other's cache) and shuffled per epoch by an explicit numpy RNG, exactly
as the JAX training loop does, so the port's batches are JAX's. In a
data-parallel run each rank holds an interleaved share of the records
(record ``i`` of all shards goes to rank ``i % P``, ``pipeline.py:98-171``)
under its own cache name, and the surrogate set's rows likewise; the
config's sizes stay global.

:class:`DeviceStore` is the counterpart of the JAX ``DeviceStore``: the
signals go to the card once and each batch is gathered there by index. Where
they do not fit (``--device_store``), :class:`HostBatches` copies each batch
from pinned host memory, and in a training epoch
:class:`DevicePrefetcher` (the JAX package's, ``pipeline.py:328-374``)
gathers and copies the next batches from a background thread while the
current step runs.
"""

from __future__ import annotations

import contextlib
import glob
import os
import pickle
import queue
import threading
from math import ceil
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from calciumgan_tpu_torch.algorithms.gan import denormalize
from calciumgan_tpu_torch.data import tfrecord
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import h5, tracing


class ArrayDataset:
    """An in-memory (signals, spikes) dataset with epoch iteration (copy of
    the JAX package's ``ArrayDataset``)."""

    def __init__(self, signals: np.ndarray, spikes: np.ndarray):
        if len(signals) != len(spikes):
            raise ValueError(f"{len(signals)} signals vs {len(spikes)} "
                             f"spikes")
        self.signals = signals
        self.spikes = spikes

    def __len__(self):
        return len(self.signals)

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None,
                drop_remainder: bool = False
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self)
        order = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        end = n - n % batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            yield self.signals[idx], self.spikes[idx]

    def steps(self, batch_size: int, drop_remainder: bool = False) -> int:
        if drop_remainder:
            return len(self) // batch_size
        return ceil(len(self) / batch_size)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_info(input_dir: str) -> dict:
    with open(os.path.join(input_dir, "info.pkl"), "rb") as f:
        return pickle.load(f)


def apply_dataset_info(config, info: dict) -> None:
    """Copy dataset metadata onto the config
    (reference ``dataset_helper.py:113-144``)."""
    config.train_files = os.path.join(config.input_dir, "train-*.record")
    config.validation_files = os.path.join(config.input_dir,
                                           "validation-*.record")
    for key in ("train_size", "validation_size", "sequence_length",
                "num_neurons", "num_channels", "num_train_shards",
                "num_validation_shards", "buffer_size", "normalize", "fft",
                "conv2d"):
        setattr(config, key, info[key])
    config.signal_shape = tuple(info["signal_shape"])
    config.spike_shape = tuple(info["spike_shape"])
    config.fft_norm = info.get("fft_norm", "global")
    if config.normalize:
        # per-channel fft norm stores one (min, max) per coefficient
        # position, shaped like signal_shape; global norm stores scalars
        if np.ndim(info["signals_min"]):
            config.signals_min = np.asarray(info["signals_min"], np.float32)
            config.signals_max = np.asarray(info["signals_max"], np.float32)
        else:
            config.signals_min = float(info["signals_min"])
            config.signals_max = float(info["signals_max"])
    if config.save_generated:
        set_generated_paths(config)


def set_generated_paths(config) -> None:
    """``--save_generated``: the run's ``generated`` directory and the name
    of its validation cache, in the container this installation writes."""
    config.generated_dir = os.path.join(config.output_dir, "generated")
    os.makedirs(config.generated_dir, exist_ok=True)
    config.validation_cache = os.path.join(
        config.generated_dir,
        "validation" + h5.default_suffix(config.verbose))


def _read_shards(pattern: str, signal_shape, spike_shape,
                 process_index: int = 0, process_count: int = 1
                 ) -> ArrayDataset:
    all_files = sorted(glob.glob(pattern))
    if not all_files:
        raise FileNotFoundError(f"no record files match {pattern}")
    # decoded-array cache: the first decode persists signals and spikes as
    # .npy next to the records; later runs (resumes) memory-map them
    newest = max(os.path.getmtime(f) for f in all_files)
    tag = os.path.basename(pattern).split("-")[0].rstrip("*")
    cache_base = os.path.join(
        os.path.dirname(pattern),
        f".{tag}.cache-{process_index:03d}-of-{process_count:03d}")
    sig_npy, spk_npy = cache_base + ".signals.npy", cache_base + ".spikes.npy"
    if (os.path.exists(sig_npy) and os.path.exists(spk_npy)
            # both files must postdate the records: a run killed between
            # the two os.replace calls below leaves a stale pair
            and min(os.path.getmtime(sig_npy),
                    os.path.getmtime(spk_npy)) >= newest):
        return ArrayDataset(np.load(sig_npy, mmap_mode="r"),
                            np.load(spk_npy, mmap_mode="r"))
    # record-level interleave over all shards: every rank holds floor(N/P)
    # or one more, which the uniform step count of train._epoch_steps
    # rests on (a shard-level split could starve a rank, whose missing
    # collectives would hang the others)
    signals, spikes = [], []
    i = 0
    for path in all_files:
        for signal, spike in tfrecord.read_signal_records(
                path, signal_shape, spike_shape):
            if i % process_count == process_index:
                signals.append(signal)
                spikes.append(spike)
            i += 1
    if not signals:
        raise ValueError(
            f"process {process_index}/{process_count} received no records "
            f"for {pattern}")
    signals, spikes = np.stack(signals), np.stack(spikes)
    try:  # best-effort cache write, atomic, tmp names unique per writer
        uid = f".tmp.{os.getpid()}.{threading.get_ident()}.npy"
        np.save(sig_npy + uid, signals)
        np.save(spk_npy + uid, spikes)
        os.replace(sig_npy + uid, sig_npy)
        os.replace(spk_npy + uid, spk_npy)
    except OSError:
        pass
    return ArrayDataset(signals, spikes)


def load_tfrecord_datasets(config) -> Tuple[ArrayDataset, ArrayDataset]:
    if not os.path.exists(config.input_dir):
        raise FileNotFoundError(
            f"input directory {config.input_dir} cannot be found")
    apply_dataset_info(config, load_info(config.input_dir))
    rank = (mesh_lib.data_index(), mesh_lib.data_extent())
    train = _read_shards(config.train_files, config.signal_shape,
                         config.spike_shape, *rank)
    validation = _read_shards(config.validation_files, config.signal_shape,
                              config.spike_shape, *rank)
    return train, validation


def load_surrogate_datasets(config) -> Tuple[ArrayDataset, ArrayDataset]:
    """Surrogate pickle path (reference ``dataset_helper.py:54-110``):
    transpose to (trial, time, neuron), min-max normalise, split at 8192."""
    filename = os.path.join(config.input_dir, "training.pkl")
    if not os.path.exists(filename):
        raise FileNotFoundError(f"training dataset {filename} not found")
    with open(filename, "rb") as f:
        data = pickle.load(f)

    signals = np.transpose(data["signals"], (0, 2, 1)).astype(np.float32)
    config.signals_min = float(np.min(signals))
    config.signals_max = float(np.max(signals))
    signals = (signals - config.signals_min) / (
        config.signals_max - config.signals_min)
    spikes = np.asarray(data["spikes"], np.float32)

    # the reference records the actual split length, so a smaller pickle
    # does not inflate train_size past the data
    train_size = min(8192, len(signals))
    config.train_size = train_size
    config.validation_size = len(signals) - train_size
    # each data index keeps an interleaved share of the rows
    pi, pc = mesh_lib.data_index(), mesh_lib.data_extent()
    train = ArrayDataset(signals[:train_size][pi::pc],
                         spikes[:train_size][pi::pc])
    validation = ArrayDataset(signals[train_size:][pi::pc],
                              spikes[train_size:][pi::pc])
    config.signal_shape = train.signals.shape[1:]
    config.spike_shape = spikes.shape[1:]
    config.sequence_length = train.signals.shape[1]
    config.num_neurons = train.signals.shape[-1]
    config.num_channels = train.signals.shape[-1]
    config.normalize = True
    config.fft = False
    config.conv2d = False
    if config.save_generated:
        set_generated_paths(config)
    return train, validation


def get_datasets(config) -> Tuple[ArrayDataset, ArrayDataset]:
    """Top-level dispatch (reference ``dataset_helper.py:185-206``)."""
    config.noise_shape = (config.noise_dim,)
    if config.surrogate_ds:
        train, validation = load_surrogate_datasets(config)
    else:
        train, validation = load_tfrecord_datasets(config)
    config.train_steps = ceil(config.train_size / config.batch_size)
    config.validation_steps = ceil(
        config.validation_size / config.batch_size)
    return train, validation


# ---------------------------------------------------------------------------
# batches on the device
# ---------------------------------------------------------------------------

class DeviceStore:
    """The signals on ``device`` once; :meth:`batch` gathers rows there, so
    a step moves only its index vector. A rank's store holds that rank's
    rows only."""

    def __init__(self, signals: np.ndarray, device):
        self.device = torch.device(device)
        # a copy: the signals may be a read-only memory map of the cache
        self.signals = torch.from_numpy(np.array(signals, np.float32)).to(
            self.device)

    def __len__(self):
        return len(self.signals)

    @property
    def nbytes(self) -> int:
        return self.signals.numel() * self.signals.element_size()

    def batch(self, idx: np.ndarray) -> torch.Tensor:
        """The rows ``idx``, gathered on the device as the span
        ``data/gather``."""
        with tracing.span("data/gather"):
            index = torch.from_numpy(np.asarray(idx, np.int64)).to(
                self.device)
            return self.signals.index_select(0, index)


class HostBatches:
    """Batches gathered on the host and copied to ``device`` per step, from
    pinned memory when the device is a GPU."""

    def __init__(self, signals: np.ndarray, device):
        self.device = torch.device(device)
        self.signals = signals

    def __len__(self):
        return len(self.signals)

    def host_rows(self, idx: np.ndarray) -> torch.Tensor:
        """``signals[idx]`` on the host, pinned when the device is a GPU."""
        rows = torch.from_numpy(np.ascontiguousarray(
            self.signals[np.asarray(idx)], np.float32))
        return rows.pin_memory() if self.device.type == "cuda" else rows

    def batch(self, idx: np.ndarray) -> torch.Tensor:
        rows = self.host_rows(idx)
        return rows.to(self.device, non_blocking=rows.is_pinned())


class DevicePrefetcher:
    """The batches of ``source`` (a :class:`HostBatches`) at each index
    array of ``batches``, in that order, staged by a background thread up
    to ``depth`` batches ahead (counterpart of the JAX package's
    ``DevicePrefetcher``, ``pipeline.py:328-374``: a daemon worker, a queue
    of ``depth``, an error in the worker raised at the consumer after the
    batches before it, a sentinel that ends the iteration; the thread is
    joined at the sentinel).

    On a GPU the worker gathers and pins the rows, then copies them on a
    side stream of the source's device (a copy from the worker on the
    default stream would queue behind the step's kernels) and records an
    event; the consumer's current stream waits on that event, and the
    batch is recorded on that stream so the caching allocator keeps its
    memory until the step has read it. The worker enters the source's
    device, since a new thread starts on ``cuda:0``. On the CPU the worker
    gathers on the host and no stream is used (:attr:`stream`, the side
    stream, is None)."""

    def __init__(self, source: HostBatches, batches: Iterable[np.ndarray],
                 depth: int = 2):
        self._source = source
        self._batches = batches
        self.stream = None
        if source.device.type == "cuda":
            index = source.device.index
            device = torch.device("cuda", torch.cuda.current_device()
                                  if index is None else index)
            self.stream = torch.cuda.Stream(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="DevicePrefetcher")
        self._thread.start()

    def _stage(self, idx):
        rows = self._source.host_rows(idx)
        if self.stream is None:
            return rows, None
        with torch.cuda.stream(self.stream):
            batch = rows.to(self.stream.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return batch, ready

    def _worker(self):
        try:
            with (contextlib.nullcontext() if self.stream is None
                  else torch.cuda.device(self.stream.device)):
                for idx in self._batches:
                    self._q.put(self._stage(idx))
        except Exception as e:  # surface worker errors to the consumer
            self._q.put(e)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        with tracing.span("data/wait"):
            item = self._q.get()
        if item is None:
            self._thread.join()
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        batch, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(batch.device)
            current.wait_event(ready)
            batch.record_stream(current)
        return batch


def device_store_enabled(config, nbytes: int, device) -> bool:
    """``auto``: a GPU device and the signals fit ``--device_store_mb``;
    ``on``/``off`` force it."""
    mode = getattr(config, "device_store", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    budget = int(getattr(config, "device_store_mb", 4096)) * 2**20
    return torch.device(device).type == "cuda" and nbytes <= budget


# ---------------------------------------------------------------------------
# reverse preprocessing (reference utils.py:49-63)
# ---------------------------------------------------------------------------

def ifft_signals(signals: np.ndarray) -> np.ndarray:
    """Inverse FFT of ``(N, W, C)`` spectra, real part only: a copy of
    ``ifft_signals`` in ``calciumgan_tpu/data/segments.py``. The channel
    axis holds the real halves then the imaginary halves. Generated spectra
    are not conjugate-symmetric, so this stays a full complex ifft with the
    imaginary residue dropped; the transform axis is made contiguous
    first."""
    mid = signals.shape[-1] // 2
    spec = np.ascontiguousarray(np.moveaxis(
        signals[..., :mid] + 1j * signals[..., mid:], 1, 2).astype(
            np.complex64))
    out = np.fft.ifft(spec, axis=-1).real
    return np.ascontiguousarray(np.moveaxis(out, 2, 1)).astype(np.float32)


def reverse_preprocessing(config, x: torch.Tensor) -> torch.Tensor:
    """Generator output -> signals in recording units, NWC, on ``x``'s
    device: denormalise, undo the conv2d channel layout, inverse FFT (on the
    host, through :func:`ifft_signals`)."""
    x = denormalize(config, x)
    if config.conv2d:
        if config.fft:
            x = torch.cat((x[..., 0], x[..., 1]), dim=-1)
        else:
            x = x.squeeze(-1)
    if config.fft:
        x = torch.from_numpy(ifft_signals(x.cpu().numpy())).to(x.device)
    return x
