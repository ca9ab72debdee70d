"""Checkpoints: the port's own save, restore and resume, and the import of
JAX training checkpoints (counterpart of ``calciumgan_tpu/utils/
checkpoint.py``).

The port writes its whole train state (both nets' parameters, Adam states
and update counts, the generator EMA) with ``torch.save`` to
``<ckpt_dir>/epoch-NNN.pt``, and ``{"epoch", "global_step"}`` to
``latest.json``, each atomically (tmp + ``os.replace``), as the JAX package
writes ``epoch-NNN.msgpack`` (``checkpoint.py:33-62``). :func:`resume`
continues from the newest ``.pt`` (``start_epoch = epoch + 1``, the stored
``global_step``), reconciling the EMA as ``_reconcile_ema`` does. A
model-parallel run's sharded parameters (their Adam moments and EMA too)
are gathered into whole tensors before rank 0 writes, so the file is a
one-process run's, and each rank keeps its block on restore.

The JAX package's msgpack is decoded with ``msgpack`` alone (no Flax):
arrays are msgpack ext type 1 (``npscalar`` 3) holding a packed ``(shape,
dtype name, C-order bytes)`` triple, and arrays above 1 GiB are split into
``__msgpack_chunked_array__`` dictionaries. ``msgpack`` is imported on use,
so the library core does not need it. :func:`restore_generator_params`
serves either format to ``generate``: the generator's variables (the EMA or
raw parameters beside its BatchNorm running statistics, which the EMA does
not average).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.algorithms.gan import eval_gen_variables
from calciumgan_tpu_torch.algorithms.state import GANState
from calciumgan_tpu_torch.parallel import mesh as mesh_lib

_EPOCH_RE = re.compile(r"epoch-(\d+)\.(msgpack|pt)$")
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    """The JAX package's checkpoint of ``epoch``."""
    return os.path.join(ckpt_dir, f"epoch-{epoch:03d}.msgpack")


def port_checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    """The port's checkpoint of ``epoch``."""
    return os.path.join(ckpt_dir, f"epoch-{epoch:03d}.pt")


def _epochs(ckpt_dir: str, formats=("msgpack", "pt")) -> list:
    return [int(m[1]) for p in glob.glob(os.path.join(ckpt_dir, "epoch-*"))
            if (m := _EPOCH_RE.search(p)) and m[2] in formats]


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The epoch ``latest.json`` names when its checkpoint (``.pt`` or
    ``.msgpack``) exists, else the newest ``epoch-NNN`` of either (None when
    there is none)."""
    meta = os.path.join(ckpt_dir, "latest.json")
    if os.path.exists(meta):
        with open(meta) as f:
            epoch = json.load(f).get("epoch")
        if epoch is not None and int(epoch) in _epochs(ckpt_dir):
            return int(epoch)
    epochs = _epochs(ckpt_dir)
    return max(epochs) if epochs else None


def _write_atomic(path: str, write) -> None:
    tmp = f"{path}.tmp"
    write(tmp)
    os.replace(tmp, path)  # a preempted save never corrupts a resume


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _reshard(net, params: dict, opt_state: dict, ema, fn) -> None:
    """``fn(tensor, dim, group)`` in place of each model-sharded tensor of
    ``net``'s ``params``, of its Adam moments in ``opt_state`` (keyed by
    parameter order) and of ``ema`` (the generator's, or None)."""
    shards = mesh_lib.sharded_parameters(net.module)
    names = [n for n, _ in net.module.named_parameters()]
    for i, name in enumerate(names):
        if name not in shards:
            continue
        dim, group = shards[name]
        params[name] = fn(params[name], dim, group)
        moments = opt_state["state"].get(i)
        if moments is not None:  # a copy: the optimizer's own dictionary
            opt_state["state"][i] = dict(moments, **{
                k: fn(moments[k], dim, group) for k in _MOMENTS})
        if ema is not None and name in ema:
            ema[name] = fn(ema[name], dim, group)


def save(ckpt_dir: str, epoch: int, state: GANState, config=None,
         verbose: int = 1) -> str:
    """Write the whole train state of ``epoch`` to ``epoch-NNN.pt`` and
    ``latest.json``. In a parallel run every rank calls it: model-sharded
    tensors are gathered first, then rank 0 is the one writer (every other
    tensor is the same on every rank, ``checkpoint.py:37-43``), and every
    rank restores it."""
    path = port_checkpoint_path(ckpt_dir, epoch)
    global_step = None if config is None else int(config.global_step)
    ema = None if state.ema is None else dict(state.ema)
    payload = {"epoch": epoch, "global_step": global_step, "ema": ema}
    for name in ("generator", "discriminator"):
        net = getattr(state, name)
        payload[name] = {"params": net.module.state_dict(),
                         "opt_state": net.optimizer.state_dict(),
                         "step": net.step}
        opt_state = payload[name]["opt_state"]
        opt_state["state"] = dict(opt_state["state"])
        _reshard(net, payload[name]["params"], opt_state,
                 ema if name == "generator" else None,
                 mesh_lib.gather_shard)
    if mesh_lib.process_index() != 0:
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    _write_atomic(path, lambda tmp: torch.save(payload, tmp))
    meta = {"epoch": epoch}
    if global_step is not None:
        meta["global_step"] = global_step

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _write_atomic(os.path.join(ckpt_dir, "latest.json"), write_meta)
    if verbose:
        print(f"Saved checkpoint to {path}")
    return path


def _reconcile_ema(state: GANState, stored: dict, verbose: int) -> None:
    """The EMA is optional across runs (``checkpoint.py:74-91``): resuming
    with ``--ema`` off drops a stored average; resuming with it on from a
    checkpoint without one seeds it from the restored generator params."""
    if state.ema is None:
        return
    source = stored["ema"]
    if source is None:
        source = stored["generator"]["params"]
        if verbose:
            print("Checkpoint has no generator EMA: seeded --ema from the "
                  "restored params")
    with torch.no_grad():
        for name, tensor in state.ema.items():
            tensor.copy_(source[name])


def restore(ckpt_dir: str, state: GANState, epoch: Optional[int] = None,
            verbose: int = 1) -> Tuple[Optional[int], Optional[int]]:
    """Load the newest (or ``epoch``'s) ``.pt`` checkpoint into ``state`` in
    place, onto the device its modules live on. Returns ``(epoch,
    global_step)``, ``(None, None)`` when there is no ``.pt`` checkpoint."""
    if epoch is None:
        epochs = _epochs(ckpt_dir, ("pt",))
        epoch = max(epochs) if epochs else None
    if epoch is None:
        return None, None
    path = port_checkpoint_path(ckpt_dir, epoch)
    device = next(state.generator.module.parameters()).device
    stored = torch.load(path, map_location=device, weights_only=True)
    for name in ("generator", "discriminator"):
        net, saved = getattr(state, name), stored[name]
        _reshard(net, saved["params"], saved["opt_state"],
                 stored["ema"] if name == "generator" else None,
                 mesh_lib.shard_of)
        net.module.load_state_dict(saved["params"])
        net.optimizer.load_state_dict(saved["opt_state"])
        net.step = int(saved["step"])
    _reconcile_ema(state, stored, verbose)
    if verbose:
        print(f"Restored checkpoint at {path}")
    return epoch, stored["global_step"]


def resume(config, state: GANState) -> GANState:
    """Auto-resume (reference ``utils.py:135-152``): restore the newest
    ``.pt`` under ``config.ckpt_dir`` and set ``start_epoch = epoch + 1``
    and ``global_step`` to the stored count."""
    if config.ckpt_dir is None:
        config.ckpt_dir = os.path.join(config.output_dir, "checkpoints")
    config.start_epoch = 0
    if not os.path.isdir(config.ckpt_dir):
        return state
    epoch, global_step = restore(config.ckpt_dir, state,
                                 verbose=config.verbose)
    if epoch is not None:
        config.start_epoch = epoch + 1
        if global_step is not None:
            config.global_step = int(global_step)
    return state


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
    """Generator variables of a JAX checkpoint: ``({"params": ...,
    "batch_stats": ...}, epoch)``.

    ``epoch=None`` takes :func:`latest_epoch`. With ``ema`` (the run's
    ``--ema`` > 0) the stored generator EMA is the ``params`` when the
    checkpoint has one, else the raw generator params, as the JAX restore
    seeds a missing average from them (``checkpoint.py:74-91``); ``ema=False``
    takes the raw params (``generate.py --ema 0``). ``batch_stats`` is the
    generator's in either case (``{}`` without BatchNorm)."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    state = read_state(checkpoint_path(ckpt_dir, epoch))
    if not ema:
        state = dict(state, ema_params=None)
    return eval_gen_variables(state), epoch


def restore_generator_params(ckpt_dir: str, epoch: Optional[int] = None,
                             ema: bool = True,
                             model: str = "calciumgan") -> Tuple[dict, int]:
    """Generator variables (Flax layout, ``{"params": ..., "batch_stats":
    ...}``, as ``generate`` takes them) of a ``model`` (the run's
    ``config.model``) from the port's ``epoch-NNN.pt`` when it exists for
    ``epoch`` (default :func:`latest_epoch`), else of JAX's
    ``epoch-NNN.msgpack`` through :func:`import_jax_checkpoint`. With
    ``ema`` the stored EMA's parameters are taken when there is one, else
    the raw ones; the running statistics are the generator's buffers."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = port_checkpoint_path(ckpt_dir, epoch)
    if not os.path.exists(path):
        return import_jax_checkpoint(ckpt_dir, epoch, ema)
    stored = torch.load(path, map_location="cpu", weights_only=True)
    weights = dict(stored["generator"]["params"])
    if ema and stored["ema"] is not None:
        weights.update(stored["ema"])
    return convert.flax_generator_variables(weights, model), epoch
