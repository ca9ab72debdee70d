"""Ranks, groups and rows of a data-parallel run (counterpart of the data
axis of ``calciumgan_tpu/parallel/mesh.py``).

JAX drives every device of a host from one process, shards the batch over
a ``data`` axis and lets its partitioner insert the collectives. PyTorch
runs one process, a rank, per GPU, so the port calls its collectives
itself:

- :func:`create_mesh` validates a layout with the JAX package's rules and
  messages (``mesh.py:18-66``) and orders its ranks slice-major. A layout
  holds the devices only: a rank's identity is the process group's
  (:func:`process_index`, :func:`process_count`, :func:`data_group`);
- a rank holds only the rows of its share of the global batch, so JAX's
  ``put_batch``, ``shard_batch`` and ``local_rows`` (``mesh.py:196-263``)
  have nothing to assemble: :func:`rows_of` cuts rank ``r``'s rows out of
  a global batch;
- the collectives of a train step go through the functions below and
  count themselves in :data:`collectives`: :func:`all_reduce_mean` (the
  gradients and the logs), :func:`all_reduce_sum` (the masked means and
  the BatchNorm statistics, through autograd where the step
  backpropagates).

A process that joined no process group is the one process of its run:
:func:`data_group` is None and no function here calls a collective. A
rank that joined one calls them whatever the group's size, so a
``torchrun`` world of one runs the collective path too. With model
parallelism still to port, the data axis is the whole world.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# collective calls by name since the last clear (launches of the
# collectives this package makes, on this rank)
collectives: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel layout: one device per rank, slice-major."""

    devices: Tuple[str, ...]
    data_parallelism: int
    slices: int = 1

    @property
    def device(self) -> torch.device:
        """This process's device: the entry of its rank."""
        return torch.device(self.devices[process_index()])


def visible_devices(device="cuda", host_ranks: int = 1) -> list:
    """What ``jax.devices()`` is to the JAX package: every visible GPU for
    a CUDA ``device`` without an index, the one device it names with one;
    ``host_ranks`` entries of the host for the CPU, whose ranks share its
    cores."""
    device = torch.device(device)
    if device.type == "cpu":
        return ["cpu"] * host_ranks
    if device.type == "cuda" and device.index is None:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(device)]


def create_mesh(data_parallelism: int = -1, model_parallelism: int = 1,
                devices: Optional[Sequence] = None, slices: int = 1) -> Mesh:
    """The ranks of a ``(slice, data)`` layout over ``devices`` (default:
    every visible GPU), with the JAX package's validation and messages.
    ``data_parallelism=-1`` takes every device of a slice; the ranks of
    slice ``s`` are the first ``data_parallelism`` devices of its
    contiguous block of ``len(devices) / slices``."""
    if model_parallelism > 1:
        raise NotImplementedError(
            f"--model_parallelism {model_parallelism}: model parallelism "
            "(the parameter sharding rules of parallel/mesh.py) is not "
            "ported yet; the port shards the batch only")
    devices = [str(d) for d in (devices if devices is not None
                                else visible_devices())]
    if slices > 1 and len(devices) % slices:
        raise ValueError(
            f"{len(devices)} devices not divisible by {slices} slices")
    per_slice = len(devices) // slices
    if data_parallelism == -1:
        if per_slice % model_parallelism:
            raise ValueError(
                f"{per_slice} devices/slice not divisible by "
                f"model_parallelism {model_parallelism}")
        data_parallelism = per_slice // model_parallelism
    n = slices * data_parallelism * model_parallelism
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    ranks = [d for s in range(slices)
             for d in devices[s * per_slice:s * per_slice + data_parallelism]]
    return Mesh(tuple(ranks), data_parallelism, slices)


def data_group():
    """The data axis's process group, None in a process that joined none."""
    return dist.group.WORLD if dist.is_initialized() else None


def process_index() -> int:
    """This process's rank (``jax.process_index()``): 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (``jax.process_count()``): 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def data_extent(mesh: Mesh) -> int:
    """Total batch-sharding width: data axis times any outer slice axis
    (the layout's number of ranks)."""
    return mesh.data_parallelism * mesh.slices


def local_batch_size(global_batch: int) -> int:
    """This rank's rows of a global batch."""
    count = process_count()
    if global_batch % count:
        raise ValueError(
            f"batch_size {global_batch} not divisible by process count "
            f"{count}")
    return global_batch // count


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Pad dim 0 up to a multiple (repeating the last row); returns
    (padded, real_count)."""
    n = batch.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    filler = np.repeat(batch[-1:], multiple - rem, axis=0)
    return np.concatenate([batch, filler], axis=0), n


def rows_of(x, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch of ``x.shape[0]`` rows: the
    ``rank``-th of ``world`` equal blocks."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"{n} rows not divisible by {world} ranks")
    per = n // world
    return x[rank * per:(rank + 1) * per]


def all_reduce_sum(x: torch.Tensor, differentiable: bool = False
                   ) -> torch.Tensor:
    """The sum of ``x`` over the data group (``x`` itself without one).
    ``differentiable`` reduces through autograd, so a backward pass sums
    each rank's gradient of the result back into every rank's ``x``."""
    group = data_group()
    if group is None:
        return x
    collectives["all_reduce"] += 1
    if differentiable:
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(x, group=group)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> list:
    """Each tensor's mean over the data group, by one all-reduce a dtype of
    one flattened buffer (SUM, then division by the group's size): every
    rank gets the same bytes. The tensors themselves without a group."""
    tensors = list(tensors)
    group = data_group()
    if group is None:
        return tensors
    size = dist.get_world_size(group)
    out = [None] * len(tensors)
    by_dtype = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        by_dtype[t.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        collectives["all_reduce"] += 1
        dist.all_reduce(flat, group=group)
        flat /= size
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[start:start + n].view_as(tensors[i])
            start += n
    return out
