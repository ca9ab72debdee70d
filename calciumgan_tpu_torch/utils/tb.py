"""Dependency-free TensorBoard event-file writer: a copy of
``calciumgan_tpu/utils/tb.py``, with the HParams plugin events of the
sweep (``hparams_config``, ``hparams``; ``:130-198`` there), which write
the same bytes as the JAX package's for the same arguments and clock.

An events file is a TFRecord stream of ``Event`` protos, written with the
port's record framing and varint codec (:mod:`..data.tfrecord`).

Proto schema (field numbers from tensorboard/compat/proto):
    Event   { double wall_time=1; int64 step=2;
              oneof { string file_version=3; Summary summary=5; } }
    Summary { repeated Value value=1; }
    Value   { string tag=1; float simple_value=2; Image image=4;
              HistogramProto histo=5; }
    Image   { int32 height=1; int32 width=2; int32 colorspace=3;
              bytes encoded_image_string=4; }
    HistogramProto { double min=1; max=2; num=3; sum=4; sum_squares=5;
              repeated double bucket_limit=6 [packed]; bucket=7 [packed]; }
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import threading
import time
from typing import Sequence

import numpy as np

from calciumgan_tpu_torch.data.tfrecord import (TFRecordWriter, _len_field,
                                                _varint)


def _double_field(field_number: int, value: float) -> bytes:
    return _varint((field_number << 3) | 1) + struct.pack("<d", value)


def _float_field(field_number: int, value: float) -> bytes:
    return _varint((field_number << 3) | 5) + struct.pack("<f", value)


def _varint_field(field_number: int, value: int) -> bytes:
    return _varint(field_number << 3) + _varint(value)


def _packed_doubles(field_number: int, values: Sequence[float]) -> bytes:
    payload = b"".join(struct.pack("<d", v) for v in values)
    return _len_field(field_number, payload)


def _event(payload: bytes, step: int, wall_time: float) -> bytes:
    return (_double_field(1, wall_time) + _varint_field(2, int(step)) +
            payload)


def _value(tag: str, body: bytes) -> bytes:
    return _len_field(1, _len_field(1, tag.encode()) + body)  # Summary.value


def histogram_proto(values: np.ndarray) -> bytes:
    """TensorBoard-style exponentially-bucketed histogram."""
    values = np.asarray(values, np.float64).ravel()
    values = values[np.isfinite(values)]
    if values.size == 0:
        values = np.zeros(1)
    # exponential bucket edges, the growth factor TensorBoard uses (1.1)
    limits = [1e-12]
    while limits[-1] < max(1e-12, np.abs(values).max()) * 1.1:
        limits.append(limits[-1] * 1.1)
    edges = np.asarray([-l for l in reversed(limits)] + limits)
    counts, _ = np.histogram(values, bins=edges)
    nz = np.nonzero(counts)[0]
    if nz.size:
        lo, hi = nz[0], nz[-1] + 1
        bucket_limit = edges[1:][lo:hi]
        bucket = counts[lo:hi]
    else:
        bucket_limit, bucket = edges[1:2], counts[:1]
    return (_double_field(1, float(values.min())) +
            _double_field(2, float(values.max())) +
            _double_field(3, float(values.size)) +
            _double_field(4, float(values.sum())) +
            _double_field(5, float(np.square(values).sum())) +
            _packed_doubles(6, bucket_limit.tolist()) +
            _packed_doubles(7, bucket.astype(np.float64).tolist()))


class EventWriter:
    """Append-only writer for one TensorBoard logdir."""

    _seq = itertools.count()  # distinct names within one process

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        # pid + per-process counter: two writers created in the same second
        # must not truncate each other's file
        filename = os.path.join(
            logdir,
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.{next(self._seq)}")
        self._writer = TFRecordWriter(filename)
        self._lock = threading.Lock()
        self._write(_event(_len_field(3, b"brain.Event:2"), 0, time.time()))

    def _write(self, event: bytes) -> None:
        with self._lock:
            self._writer.write(event)

    def _summary(self, values: bytes, step: int) -> None:
        self._write(_event(_len_field(5, values), step, time.time()))

    def scalar(self, tag: str, value: float, step: int = 0) -> None:
        self._summary(_value(tag, _float_field(2, float(value))), step)

    def histogram(self, tag: str, values, step: int = 0) -> None:
        self._summary(_value(tag, _len_field(5, histogram_proto(values))),
                      step)

    def image(self, tag: str, png_bytes: bytes, height: int, width: int,
              step: int = 0, colorspace: int = 4) -> None:
        image = (_varint_field(1, height) + _varint_field(2, width) +
                 _varint_field(3, colorspace) + _len_field(4, png_bytes))
        self._summary(_value(tag, _len_field(4, image)), step)

    # ---- TensorBoard HParams plugin ----------------------------------
    # (the reference's search.py uses tensorboard.plugins.hparams; proto
    # field numbers from tensorboard/plugins/hparams/{plugin_data,api}.proto)

    def _hparams_value(self, tag: str, plugin_content: bytes) -> None:
        plugin_data = (_len_field(1, b"hparams") +
                       _len_field(2, plugin_content))
        metadata = _len_field(1, plugin_data)          # SummaryMetadata
        body = _len_field(9, metadata)                 # Value.metadata
        self._summary(_value(tag, body), step=0)

    def hparams_config(self, hparam_domains, metric_tags) -> None:
        """Experiment-level sweep schema: {name: [discrete values]} domains
        plus the metric tags shown in the HParams dashboard."""
        infos = b""
        for name, values in hparam_domains.items():
            dtype = _pb_dtype(values[0]) if values else 1
            domain = _len_field(  # HParamInfo.domain_discrete (ListValue)
                5, b"".join(_len_field(1, _pb_value(v)) for v in values))
            info = (_len_field(1, name.encode()) +
                    _varint_field(4, dtype) + domain)
            infos += _len_field(4, info)               # Experiment.hparam_infos
        metrics = b""
        for tag in metric_tags:
            metric_name = _len_field(2, tag.encode())  # MetricName.tag
            metrics += _len_field(5, _len_field(1, metric_name))
        experiment = infos + metrics
        content = _varint_field(1, 0) + _len_field(2, experiment)
        self._hparams_value("_hparams_/experiment", content)

    def hparams(self, values: dict, group_name: str = "") -> None:
        """Per-trial hyper-parameter values (SessionStartInfo)."""
        entries = b""
        for name, v in values.items():
            entry = _len_field(1, name.encode()) + _len_field(2, _pb_value(v))
            entries += _len_field(1, entry)            # map entry
        info = entries
        if group_name:
            info += _len_field(4, group_name.encode())
        info += _double_field(5, time.time())          # start_time_secs
        content = _varint_field(1, 0) + _len_field(3, info)
        self._hparams_value("_hparams_/session_start_info", content)

    def flush(self) -> None:
        with self._lock:
            self._writer.flush()

    def close(self) -> None:
        with self._lock:
            self._writer.close()


def _pb_value(v) -> bytes:
    """Encode a google.protobuf.Value."""
    if isinstance(v, bool):
        return _varint_field(4, int(v))
    if isinstance(v, (int, float)):
        return _double_field(2, float(v))
    return _len_field(3, str(v).encode())


def _pb_dtype(v) -> int:
    if isinstance(v, bool):
        return 2    # DATA_TYPE_BOOL
    if isinstance(v, (int, float)):
        return 3    # DATA_TYPE_FLOAT64
    return 1        # DATA_TYPE_STRING
