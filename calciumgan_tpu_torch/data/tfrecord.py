"""TFRecord container and ``tf.train.Example`` codec without TensorFlow: a
copy of ``calciumgan_tpu/data/tfrecord.py``.

The reference stores (signal, spike) pairs as ``tf.train.Example`` protos
with two bytes features (``signal``, ``spike``: float32 C-order bytes)
inside TFRecord files.

TFRecord framing (per record):
    uint64 length (LE) | uint32 masked crc32c(length bytes) |
    data bytes         | uint32 masked crc32c(data)
with crc32c = Castagnoli CRC-32 (reflected poly 0x82F63B78) and
mask(c) = ((c >> 15) | (c << 17)) + 0xa282ead8 (mod 2^32).

Example proto schema (field numbers from tensorflow/core/example):
    Example { Features features = 1; }
    Features { map<string, Feature> feature = 1; }
    Feature { BytesList bytes_list = 1; FloatList float_list = 2;
              Int64List int64_list = 3; }
    BytesList { repeated bytes value = 1; }

crc32c is the port's copy of the JAX package's slice-by-8 C++
(``csrc/crc32c.cc``), compiled at first use by
:func:`calciumgan_tpu_torch.kernels.build.load_host`. A failed build
raises: a pure-Python crc over records of hundreds of kilobytes would take
minutes.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, Iterator, List

import numpy as np

from calciumgan_tpu_torch.kernels import build


def crc_library() -> build.Built:
    built = build.load_host("crc32c", build.CSRC / "crc32c.cc")
    fn = built.lib.cg_crc32c
    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    fn.restype = ctypes.c_uint32
    return built


def crc32c(data: bytes) -> int:
    return int(crc_library().lib.cg_crc32c(data, len(data)))


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------

class TFRecordWriter:

    def __init__(self, path: str, buffering: int = 4 * 1024 * 1024):
        self._f = open(path, "wb", buffering=buffering)

    def write(self, data: bytes) -> None:
        length = struct.pack("<Q", len(data))
        self._f.write(length + struct.pack("<I", masked_crc32c(length)) +
                      data + struct.pack("<I", masked_crc32c(data)))

    def flush(self) -> None:
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, check_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            footer = f.read(4)
            if check_crc:
                (lc,) = struct.unpack("<I", header[8:12])
                (dc,) = struct.unpack("<I", footer)
                if lc != masked_crc32c(header[:8]) or \
                        dc != masked_crc32c(data):
                    raise IOError(f"corrupt TFRecord in {path}")
            yield data


# ---------------------------------------------------------------------------
# minimal protobuf wire codec
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_field(field_number: int, payload: bytes) -> bytes:
    # wire type 2 (length-delimited)
    return _varint((field_number << 3) | 2) + _varint(len(payload)) + payload


def _walk(buf: bytes) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value) triples of one message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


# ---------------------------------------------------------------------------
# Example encode/decode
# ---------------------------------------------------------------------------

def encode_example(features: Dict[str, bytes]) -> bytes:
    """Example with one bytes value per feature name, in insertion order."""
    entries = b""
    for name, value in features.items():
        bytes_list = _len_field(1, value)           # BytesList.value
        feature = _len_field(1, bytes_list)         # Feature.bytes_list
        entry = _len_field(1, name.encode()) + _len_field(2, feature)
        entries += _len_field(1, entry)             # Features.feature entry
    return _len_field(1, entries)                   # Example.features


def decode_example(buf: bytes) -> Dict[str, List[bytes]]:
    """Decode to {feature name: [bytes values]}."""
    out: Dict[str, List[bytes]] = {}
    for field, _, features_buf in _walk(buf):
        if field != 1:
            continue
        for f2, _, entry in _walk(features_buf):
            if f2 != 1:
                continue
            name, values = None, []
            for f3, _, v in _walk(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    for f4, _, lst in _walk(v):
                        if f4 == 1:  # bytes_list
                            for f5, _, item in _walk(lst):
                                if f5 == 1:
                                    values.append(item)
            if name is not None:
                out[name] = values
    return out


# ---------------------------------------------------------------------------
# high-level (signal, spike) helpers
# ---------------------------------------------------------------------------

def write_signal_records(path: str, signals: np.ndarray,
                         spikes: np.ndarray, indexes) -> None:
    with TFRecordWriter(path) as w:
        for i in indexes:
            w.write(encode_example({
                "signal": np.ascontiguousarray(
                    signals[i], dtype=np.float32).tobytes(),
                "spike": np.ascontiguousarray(
                    spikes[i], dtype=np.float32).tobytes(),
            }))


def read_signal_records(path: str, signal_shape, spike_shape):
    """Yield (signal, spike) float32 arrays from one shard."""
    for rec in read_records(path):
        feats = decode_example(rec)
        signal = np.frombuffer(feats["signal"][0], np.float32).reshape(
            signal_shape)
        spike = np.frombuffer(feats["spike"][0], np.float32).reshape(
            spike_shape)
        yield signal, spike
