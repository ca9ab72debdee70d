"""Offline preprocessing: segmentation, FFT, conv2d reshape, normalisation,
sharded record writing, and the ``info.pkl`` metadata contract: a copy of
``calciumgan_tpu/data/segments.py`` (numpy only), writing through the port's
own TFRecord codec. ``ifft_signals`` is
:func:`calciumgan_tpu_torch.data.pipeline.ifft_signals`, re-exported here.

Parity with the reference's ``dataset/generate_tfrecords.py``:
- drop the first 2 neurons of recorded (non-DG) data (``:67-70``),
- transpose to WC (time, neuron) then sliding windows of ``sequence_length``
  advanced by ``stride`` with the reference's strict ``<`` bound (``:81-89``),
- optional per-(segment, neuron) FFT -> concat(real, imag) channels
  (``:30-42``): vectorised np.fft instead of the reference's per-trace
  ``tf.signal.fft`` python loops,
- optional conv2d reshape to (seq, neurons, 1|2) (``:96-108``),
- min-max normalisation to [0, 1] recording global min/max (``:113-120``),
- shard-size heuristic, ``{mode}-{i:03d}-of-{n:03d}.record`` naming, and the
  info.pkl keys (``:45-53,141-143,227-248``).
"""

from __future__ import annotations

import os
import pickle
from math import ceil
from typing import Tuple

import numpy as np

from calciumgan_tpu_torch.data import tfrecord
from calciumgan_tpu_torch.data.pipeline import ifft_signals  # noqa: F401


def split_index(length: int, n: int):
    k, m = divmod(length, n)
    return [(i * k + min(i, m), (i + 1) * k + min(i + 1, m))
            for i in range(n)]


def split(sequence, n: int):
    return [sequence[a:b] for a, b in split_index(len(sequence), n)]


def normalize(x, x_min, x_max):
    span = np.asarray(x_max, np.float32) - np.asarray(x_min, np.float32)
    # zero-span coefficients (e.g. the imaginary DC bin is identically 0
    # under per-channel fft norm) map to 0; denormalize inverts exactly
    # because x * 0 + x_min == x_min there
    return (x - x_min) / np.where(span == 0, np.float32(1), span)


def fft_signals(signals: np.ndarray) -> np.ndarray:
    """(N, seq, neurons) -> (N, seq, 2*neurons): concat(real, imag).

    The input is real, so the full spectrum is built from ``rfft`` over a
    contiguous last axis plus a conjugate mirror, which spares pocketfft
    the complex input and the strided-axis transposes of a complex FFT
    along a middle axis.
    """
    x = np.moveaxis(np.asarray(signals, np.float32), 1, 2)  # (N, C, T)
    T = x.shape[-1]
    half = np.fft.rfft(np.ascontiguousarray(x), axis=-1)  # (N, C, T//2+1)
    spec = np.empty(x.shape, np.complex64)
    spec[..., :T // 2 + 1] = half
    # k = T//2+1 .. T-1 mirrors conj(spec[T-k]); T-k = T - T//2 - 1 .. 1
    spec[..., T // 2 + 1:] = np.conj(half[..., 1:(T + 1) // 2][..., ::-1])
    return np.concatenate(
        [np.moveaxis(spec.real, 2, 1), np.moveaxis(spec.imag, 2, 1)],
        axis=-1).astype(np.float32, copy=False)


def window_starts(T: int, sequence_length: int, stride: int) -> np.ndarray:
    """Window start offsets over a T-frame recording.

    THE single definition of the reference's strict bound ``i + seq < T``
    (a window ending exactly at T is excluded -
    ``generate_tfrecords.py:83``); both :func:`segment_recording` and the
    chunk-streaming :func:`preprocess` gather through it so the bound
    cannot drift between them.
    """
    assert stride >= 1
    return np.arange(0, max(T - sequence_length, 0), stride)


def segment_recording(raw_signals: np.ndarray, raw_spikes: np.ndarray,
                      sequence_length: int, stride: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows over a (time, neurons) recording.

    Small-array reference implementation of the windowing contract (the
    streaming :func:`preprocess` produces identical segments through the
    shared :func:`window_starts`; asserted by
    ``tests/test_data.py::test_preprocess_matches_segment_recording``).
    """
    # callers hand in a time-major VIEW of neuron-major data; a fancy-index
    # gather through that stride pattern touches one cache line per
    # element, so copy contiguously first (the raw recording is small)
    raw_signals = np.ascontiguousarray(raw_signals, dtype=np.float32)
    raw_spikes = np.ascontiguousarray(raw_spikes, dtype=np.float32)
    starts = window_starts(raw_signals.shape[0], sequence_length, stride)
    # vectorised gather instead of a python append loop
    idx = starts[:, None] + np.arange(sequence_length)[None, :]
    return raw_signals[idx], raw_spikes[idx]


def num_per_shard(sequence_length: int, fft: bool,
                  target_shard_size: float) -> int:
    """Reference shard-size heuristic (``generate_tfrecords.py:45-53``)."""
    n = ceil((120 / sequence_length) * 1100) * 10
    if fft:
        n *= 2 / 3
    return int(n * target_shard_size)


def preprocess(data: dict, sequence_length: int, stride: int,
               apply_fft: bool = False, conv2d: bool = False,
               do_normalize: bool = False, is_dg_data: bool = False,
               fft_norm: str = "global"):
    """pickle dict {'signals','oasis'} (neuron-major) -> segment tensors.

    Returns (signals, spikes, meta) where meta carries num_neurons,
    num_channels, signals_min/max.

    ``fft_norm`` selects the min-max statistics for ``--fft`` data:
    ``"global"`` keeps the reference's single scalar pair over ALL
    coefficients (``generate_tfrecords.py:113-120``), whose span the DC
    outliers dominate; ``"per_channel"`` records one (min, max)
    pair PER coefficient position (arrays of ``signal_shape``) so every
    coefficient spans its own [0, 1].
    """
    if fft_norm not in ("global", "per_channel"):
        raise ValueError(f"unknown fft_norm {fft_norm!r}")
    if fft_norm == "per_channel" and not (apply_fft and do_normalize):
        raise ValueError("fft_norm='per_channel' requires --fft --normalize")
    raw_signals = np.asarray(data["signals"], np.float32)
    raw_spikes = np.asarray(data["oasis"], np.float32)
    if not is_dg_data:
        raw_signals = raw_signals[2:]
        raw_spikes = raw_spikes[2:]
    assert raw_signals.shape == raw_spikes.shape

    # time-major, contiguous: the raw recording is small, and every chunk
    # gather below reads it
    rs = np.ascontiguousarray(np.swapaxes(raw_signals, 0, 1))
    rp = np.ascontiguousarray(np.swapaxes(raw_spikes, 0, 1))
    T, C = rs.shape
    sl = sequence_length
    starts = window_starts(T, sl, stride)
    N = len(starts)

    meta = {"num_neurons": C}
    if apply_fft and conv2d:
        sig_shape, meta["num_channels"] = (N, sl, C, 2), 2
    elif apply_fft:
        sig_shape, meta["num_channels"] = (N, sl, 2 * C), 2 * C
    elif conv2d:
        sig_shape, meta["num_channels"] = (N, sl, C, 1), 1
    else:
        sig_shape, meta["num_channels"] = (N, sl, C), C

    # Allocate ONLY the two result arrays and fill them through small
    # reused chunks (no multi-GB numpy temporaries); the normalisation
    # pass below also walks chunk-sized views.
    signals = np.empty(sig_shape, np.float32)
    spikes = np.empty((N, sl, C), np.float32)

    gmin, gmax = np.inf, -np.inf
    pmin = pmax = None
    offsets = np.arange(sl)
    chunk = max(1, (8 << 20) // max(1, sl * C * 4))
    for a in range(0, N, chunk):
        b = min(N, a + chunk)
        idx = (starts[a:b, None] + offsets[None, :]).ravel()
        sig_c = rs[idx].reshape(b - a, sl, C)
        spikes[a:b] = rp[idx].reshape(b - a, sl, C)
        if apply_fft:
            spec = fft_signals(sig_c)  # (n, sl, 2C): concat(real, imag)
            if conv2d:
                signals[a:b, :, :, 0] = spec[..., :C]
                signals[a:b, :, :, 1] = spec[..., C:]
            else:
                signals[a:b] = spec
        elif conv2d:
            signals[a:b, :, :, 0] = sig_c
        else:
            signals[a:b] = sig_c
        view = signals[a:b]
        if fft_norm == "per_channel":
            m, mx = view.min(axis=0), view.max(axis=0)
            pmin = m if pmin is None else np.minimum(pmin, m, out=pmin)
            pmax = mx if pmax is None else np.maximum(pmax, mx, out=pmax)
        else:
            gmin = min(gmin, float(view.min()))
            gmax = max(gmax, float(view.max()))

    if fft_norm == "per_channel":
        # one pair per coefficient position, shaped like signal_shape (post
        # conv2d reshape) so they broadcast in normalize/denormalize and in
        # the in-graph metric denorm; N == 0 degrades to the identity map
        # exactly like the global branch's 0.0/1.0 fallback
        if pmin is None:
            pmin = np.zeros(sig_shape[1:], np.float32)
            pmax = np.ones(sig_shape[1:], np.float32)
        meta["signals_min"] = np.asarray(pmin, np.float32)
        meta["signals_max"] = np.asarray(pmax, np.float32)
    else:
        meta["signals_min"] = gmin if N else 0.0
        meta["signals_max"] = gmax if N else 1.0
    meta["fft_norm"] = fft_norm
    if do_normalize:
        for a in range(0, N, chunk):
            b = min(N, a + chunk)
            signals[a:b] = normalize(signals[a:b], meta["signals_min"],
                                     meta["signals_max"])

    return signals, spikes, meta


def write_dataset(output_dir: str, signals: np.ndarray, spikes: np.ndarray,
                  meta: dict, sequence_length: int, stride: int,
                  validation_size: int, do_normalize: bool, apply_fft: bool,
                  conv2d: bool, target_shard_size: float = 0.5,
                  seed: int = 1234, verbose: int = 1,
                  fft_norm: str = "global") -> dict:
    """Shuffle, split, shard, write records + info.pkl; returns the info."""
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    indexes = np.arange(len(signals))
    rng.shuffle(indexes)

    validation_size = int(validation_size)
    if not 0 <= validation_size <= len(signals):
        # a too-large validation split used to write 0 train segments and
        # report a NEGATIVE train_size in info.pkl; fail loudly instead
        raise ValueError(
            f"validation_size {validation_size} must be in [0, "
            f"{len(signals)}] (the dataset has {len(signals)} segments: "
            f"a smaller --stride yields more)")
    train_size = len(signals) - validation_size
    per_shard = num_per_shard(sequence_length, apply_fft, target_shard_size)

    shard_counts = {}
    for mode, idx in (("train", indexes[:train_size]),
                      ("validation", indexes[train_size:])):
        # max(1, ...): an empty split (e.g. validation_size=0) still writes
        # one empty shard instead of divmod-by-zero inside split()
        n_shards = 1 if per_shard == 0 else max(1, ceil(len(idx) / per_shard))
        shard_counts[mode] = n_shards
        for shard, shard_idx in enumerate(split(idx, n_shards)):
            filename = os.path.join(
                output_dir,
                f"{mode}-{shard + 1:03d}-of-{n_shards:03d}.record")
            if verbose:
                print(f"writing {len(shard_idx)} segments to {filename}")
            tfrecord.write_signal_records(filename, signals, spikes,
                                          shard_idx)

    info = {
        "train_size": train_size,
        "validation_size": validation_size,
        "signal_shape": signals.shape[1:],
        "spike_shape": spikes.shape[1:],
        "sequence_length": sequence_length,
        "num_neurons": meta["num_neurons"],
        "num_channels": meta["num_channels"],
        "num_train_shards": shard_counts["train"],
        "num_validation_shards": shard_counts["validation"],
        "buffer_size": min(per_shard, train_size) if per_shard else train_size,
        "normalize": do_normalize,
        "stride": stride,
        "fft": apply_fft,
        "conv2d": conv2d,
        "fft_norm": meta.get("fft_norm", fft_norm),
    }
    if do_normalize:
        info["signals_min"] = meta["signals_min"]
        info["signals_max"] = meta["signals_max"]
    with open(os.path.join(output_dir, "info.pkl"), "wb") as f:
        pickle.dump(info, f)
    return info
