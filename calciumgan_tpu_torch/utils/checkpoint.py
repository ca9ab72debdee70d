"""Import JAX training checkpoints (counterpart of the restore half of
``calciumgan_tpu/utils/checkpoint.py:65-127``).

The JAX package writes the whole train state as Flax msgpack to
``<ckpt_dir>/epoch-NNN.msgpack`` and ``{"epoch", "global_step"}`` to
``latest.json``. This reader decodes that format with ``msgpack`` alone (no
Flax): arrays are msgpack ext type 1 (``npscalar`` 3) holding a packed
``(shape, dtype name, C-order bytes)`` triple, and arrays above 1 GiB are
split into ``__msgpack_chunked_array__`` dictionaries. ``msgpack`` is
imported on use, so the library core does not need it.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional, Tuple

import numpy as np

from calciumgan_tpu_torch.algorithms.gan import eval_gen_params

_EPOCH_RE = re.compile(r"epoch-(\d+)\.msgpack$")
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch-{epoch:03d}.msgpack")


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The epoch ``latest.json`` names when its checkpoint exists, else the
    newest ``epoch-NNN.msgpack`` (None when there is none)."""
    meta = os.path.join(ckpt_dir, "latest.json")
    if os.path.exists(meta):
        with open(meta) as f:
            epoch = json.load(f).get("epoch")
        if epoch is not None and os.path.exists(
                checkpoint_path(ckpt_dir, int(epoch))):
            return int(epoch)
    epochs = [int(m[1]) for p in glob.glob(
        os.path.join(ckpt_dir, "epoch-*.msgpack"))
        if (m := _EPOCH_RE.search(p))]
    return max(epochs) if epochs else None


def _decode_ndarray(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen to f32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack
    if code == _EXT_NDARRAY:
        return _decode_ndarray(data)
    if code == _EXT_NPSCALAR:
        return _decode_ndarray(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_state(path: str) -> dict:
    """The whole train-state dictionary of one msgpack checkpoint."""
    import msgpack
    with open(path, "rb") as f:
        state = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(state)


def import_jax_checkpoint(ckpt_dir: str, epoch: Optional[int] = None,
                          ema: bool = True) -> Tuple[dict, int]:
    """Generator params of a JAX checkpoint: ``(params, epoch)``.

    ``epoch=None`` takes :func:`latest_epoch`. With ``ema`` (the run's
    ``--ema`` > 0) the stored generator EMA is returned when the checkpoint
    has one, else the raw generator params, as the JAX restore seeds a
    missing average from them (``checkpoint.py:74-91``); ``ema=False``
    returns the raw params (``generate.py --ema 0``)."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    state = read_state(checkpoint_path(ckpt_dir, epoch))
    if not ema:
        state = dict(state, ema_params=None)
    return eval_gen_params(state), epoch
