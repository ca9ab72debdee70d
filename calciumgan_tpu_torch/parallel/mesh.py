"""Ranks, groups, rows and parameter shards of a parallel run (counterpart
of ``calciumgan_tpu/parallel/mesh.py`` and of the time mesh of
``calciumgan_tpu/parallel/long_context.py``).

JAX drives every device of a host from one process, lays the devices out
on a ``(data, model)`` or ``(data, time)`` mesh and lets its partitioner
insert the collectives. PyTorch runs one process, a rank, per GPU, so the
port calls its collectives itself:

- :func:`create_mesh` and :func:`create_time_mesh` validate a layout with
  the JAX package's rules and messages (``mesh.py:18-66``,
  ``long_context.py:40-60``) and order its ranks as the JAX mesh orders its
  devices: rank ``r`` is at ``(data, inner) = divmod(r, K)``, the model or
  time index innermost (``K`` its extent), the data index slice-major. A
  layout holds the devices only: a rank's identity is the process group's
  (:func:`process_index`, :func:`process_count`);
- :func:`init_groups` makes a process group per axis on every rank, in the
  same order: :func:`data_group` (the ranks of one model or time index),
  :func:`model_group` and :func:`time_group` (the ranks of one data index).
  :func:`data_index` and :func:`data_extent` say which rows of a global
  batch are a rank's; model and time peers hold the same rows;
- a rank holds only the rows of its share of the global batch (and under
  time parallelism only its frames of them), so JAX's ``put_batch``,
  ``shard_batch`` and ``local_rows`` (``mesh.py:196-263``) have nothing to
  assemble: :func:`rows_of` cuts rank ``r``'s rows out of a global batch,
  :func:`time_frames` a time rank's frames, :func:`gather_time` joins
  them;
- the collectives go through the functions below and count themselves in
  :data:`collectives`: :func:`gradient_mean` (the gradients),
  :func:`world_mean` (a train step's logs), :func:`all_reduce_sum` (masked
  means, real rows, BatchNorm sums) and the autograd pairs of the model and
  time axes (:func:`sum_over`, :func:`gather_last`, :func:`slice_last`,
  :func:`exchange_halos` in :mod:`.halo_conv`);
- the parameter rules of model parallelism (``mesh.py:99-131``):
  :func:`param_spec` and :func:`state_shardings` on the Flax names and
  shapes, :func:`shard_models` to cut the two sequence-sized Dense kernels
  into their shards.

A process that joined no process group is the one process of its run:
every group is None and no function here calls a collective. A rank that
joined one calls the data group's whatever its size, so a ``torchrun``
world of one runs the collective path too. Without :func:`init_groups` the
data axis is the whole world.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from calciumgan_tpu_torch.utils import tracing

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIME_AXIS = "time"

# collective calls by name since the last clear (launches of the
# collectives this package makes, on this rank), and the bytes this rank
# put into them
collectives: collections.Counter = collections.Counter()
collective_bytes: collections.Counter = collections.Counter()

# this rank's layout and groups, set by init_groups: axis -> (index,
# extent), and axis -> process group
_COORDS: Dict[str, Tuple[int, int]] = {}
_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A layout: one device per rank, rank ``r`` at ``divmod(r, K)`` of
    (data, model or time), the data axis slice-major."""

    devices: Tuple[str, ...]
    data_parallelism: int
    slices: int = 1
    model_parallelism: int = 1
    time_parallelism: int = 1

    @property
    def device(self) -> torch.device:
        """This process's device: the entry of its rank."""
        return torch.device(self.devices[process_index()])

    @property
    def shape(self) -> Dict[str, int]:
        """Axis extents, as ``jax.sharding.Mesh.shape`` (the slice axis
        folded into the data axis)."""
        return {DATA_AXIS: data_extent(self), MODEL_AXIS:
                self.model_parallelism, TIME_AXIS: self.time_parallelism}


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
    """The ranks of a ``(slice, data, model)`` layout over ``devices``
    (default: every visible GPU), with the JAX package's validation and
    messages. ``data_parallelism=-1`` takes every device of a slice; the
    ranks of slice ``s`` are the first ``data_parallelism *
    model_parallelism`` devices of its contiguous block of ``len(devices) /
    slices``, the model index innermost."""
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
    group = data_parallelism * model_parallelism
    ranks = [d for s in range(slices)
             for d in devices[s * per_slice:s * per_slice + group]]
    return Mesh(tuple(ranks), data_parallelism, slices, model_parallelism)


def create_time_mesh(data_parallelism: int = 1, time_parallelism: int = -1,
                     devices: Optional[Sequence] = None) -> Mesh:
    """The ranks of a ``(data, time)`` layout, the time index innermost;
    ``time_parallelism=-1`` uses the remaining devices."""
    devices = [str(d) for d in (devices if devices is not None
                                else visible_devices())]
    if time_parallelism == -1:
        if len(devices) % data_parallelism:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"data_parallelism {data_parallelism}")
        time_parallelism = len(devices) // data_parallelism
    n = data_parallelism * time_parallelism
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices "
                         f"({data_parallelism} data x {time_parallelism} "
                         f"time), have {len(devices)}")
    return Mesh(tuple(devices[:n]), data_parallelism,
                time_parallelism=time_parallelism)


# ---------------------------------------------------------------------------
# ranks and groups
# ---------------------------------------------------------------------------

def process_index() -> int:
    """This process's rank (``jax.process_index()``): 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (``jax.process_count()``): 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_groups(mesh: Mesh) -> None:
    """This rank's coordinates on ``mesh`` and its process group of each
    axis. Every rank of the group calls it, with the same ``mesh``: each
    ``dist.new_group`` is made on every rank in the same order. A process
    without a group keeps none; a layout of the data axis alone keeps the
    whole world as its data group."""
    forget_groups()
    if not dist.is_initialized():
        return
    inner_axis = TIME_AXIS if mesh.time_parallelism > 1 else MODEL_AXIS
    inner = mesh.model_parallelism * mesh.time_parallelism
    data = data_extent(mesh)
    if data * inner != dist.get_world_size():
        raise ValueError(f"layout of {data * inner} ranks in a process "
                         f"group of {dist.get_world_size()}")
    rank = dist.get_rank()
    _COORDS[DATA_AXIS] = (rank // inner, data)
    _COORDS[inner_axis] = (rank % inner, inner)
    if inner == 1:
        _GROUPS[DATA_AXIS] = dist.group.WORLD
        return
    collectives["new_group"] += data + inner
    for k in range(inner):
        g = dist.new_group([d * inner + k for d in range(data)])
        if rank % inner == k:
            _GROUPS[DATA_AXIS] = g
    for d in range(data):
        g = dist.new_group([d * inner + k for k in range(inner)])
        if rank // inner == d:
            _GROUPS[inner_axis] = g


def forget_groups() -> None:
    """Drop this process's layout and groups (it leaves its group)."""
    _COORDS.clear()
    _GROUPS.clear()


def data_group():
    """The data axis's process group (this rank's model or time index),
    None in a process that joined none."""
    if not dist.is_initialized():
        return None
    return _GROUPS.get(DATA_AXIS, dist.group.WORLD)


def model_group():
    """The ranks of this rank's data index on a model axis above 1, else
    None."""
    return _GROUPS.get(MODEL_AXIS)


def time_group():
    """The ranks of this rank's data index on a time axis above 1, else
    None."""
    return _GROUPS.get(TIME_AXIS)


def _count(name: str, t: torch.Tensor) -> None:
    collectives[name] += 1
    collective_bytes[name] += t.numel() * t.element_size()


def _coord(axis: str) -> Tuple[int, int]:
    if axis == DATA_AXIS and axis not in _COORDS:
        return process_index(), process_count()
    return _COORDS.get(axis, (0, 1))


def data_index() -> int:
    """Which block of a global batch's rows is this rank's."""
    return _coord(DATA_AXIS)[0]


def data_extent(mesh: Optional[Mesh] = None) -> int:
    """The number of row blocks of a global batch: data axis times any
    outer slice axis, of ``mesh`` or of this rank's layout."""
    if mesh is not None:
        return mesh.data_parallelism * mesh.slices
    return _coord(DATA_AXIS)[1]


def writes_shard() -> bool:
    """Whether this rank writes its data index's shard of a file: the
    first of its model or time peers, which hold the same rows."""
    return _coord(MODEL_AXIS)[0] == 0 and _coord(TIME_AXIS)[0] == 0


def local_batch_size(global_batch: int) -> int:
    """This rank's rows of a global batch."""
    count = data_extent()
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


def frames_of(x, index: int, extent: int):
    """Time rank ``index``'s frames (axis 1) of ``extent`` equal blocks."""
    n = x.shape[1]
    if n % extent:
        raise ValueError(f"{n} frames not divisible by {extent} ranks")
    per = n // extent
    return x[:, index * per:(index + 1) * per]


def time_frames(x):
    """This rank's frames (axis 1) of ``x``: all of them without a time
    axis."""
    return frames_of(x, *_coord(TIME_AXIS))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def all_reduce_sum(x: torch.Tensor, differentiable: bool = False,
                   group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (default the data group; ``x``
    itself without one). ``differentiable`` reduces through autograd, so a
    backward pass sums each rank's gradient of the result back into every
    rank's ``x`` (each rank's loss is its own rows')."""
    group = data_group() if group is None else group
    if group is None:
        return x
    _count("all_reduce", x)
    if differentiable:
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(x, group=group)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def metric_sum(x: torch.Tensor, differentiable: bool = False
               ) -> torch.Tensor:
    """A masked mean's ``(sum, weight)`` over every rank (through autograd
    where ``differentiable``). A value held by model or time peers alike
    is then counted by each of them, and so is its weight; a time rank's
    frames of a row are counted once each, with the row's weight counted
    once per time rank, so dividing by the weight and the rank's frames a
    row gives the global mean either way, the same bytes on every rank."""
    return all_reduce_sum(x, differentiable, group=dist.group.WORLD
                          if dist.is_initialized() else None)


def _flat_reduce(tensors: Sequence[torch.Tensor], group,
                 divisor: int) -> list:
    """Each tensor summed over ``group`` and divided by ``divisor``, by one
    all-reduce a dtype of one flattened buffer: every rank gets the same
    bytes."""
    out = [None] * len(tensors)
    by_dtype = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        by_dtype[t.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        _count("all_reduce", flat)
        dist.all_reduce(flat, group=group)
        flat /= divisor
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[start:start + n].view_as(tensors[i])
            start += n
    return out


def gradient_mean(grads: Sequence[torch.Tensor]) -> list:
    """The gradients of one update, averaged over the data axis. A model
    peer holds its shard's gradient and the whole one of every replicated
    parameter (the model axis's collectives complete it), so the mean is
    over the data group; a time peer holds its frames' share of every
    gradient, so the shares are summed over the time axis too: one
    all-reduce over every rank, divided by the data extent, as the span
    ``collective/all_reduce``."""
    grads = list(grads)
    if not dist.is_initialized():
        return grads
    with tracing.span("collective/all_reduce"):
        if time_group() is not None:
            return _flat_reduce(grads, dist.group.WORLD, data_extent())
        group = data_group()
        return _flat_reduce(grads, group, dist.get_world_size(group))


def world_mean(tensors: Sequence[torch.Tensor]) -> list:
    """Each tensor's mean over every rank: a train step's logs, whether a
    rank's value is its rows' (equal on its model peers) or its rows' and
    frames' (equal frames a rank)."""
    tensors = list(tensors)
    if not dist.is_initialized():
        return tensors
    return _flat_reduce(tensors, dist.group.WORLD, dist.get_world_size())


# ---------------------------------------------------------------------------
# the model and time axes' collectives through autograd
#
# A model or time peer computes the loss after a reduction over its group
# as every peer does, and backpropagates its own copy. So a reduction
# whose result every peer uses alike sums forward and passes the gradient
# through unchanged (torch's own all_reduce would all-reduce it again,
# multiplying it by the group's size), and a replicated activation that
# enters a sharded computation passes forward unchanged and sums its
# gradient over the group. Each is the other's backward, so a second
# derivative (the gradient penalty's) differentiates them too.
# ---------------------------------------------------------------------------

def _transport(t: torch.Tensor) -> torch.Tensor:
    """A contiguous ``t`` as its bytes, for a copy between ranks: gloo
    gathers neither half-precision floats nor 16-bit integers on every
    build, and any backend gathers bytes."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8)
    return t


def _all_gather(x: torch.Tensor, group) -> list:
    """Every rank of ``group``'s ``x`` (same shape), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _count("all_gather", x)
    dist.all_gather([_transport(p) for p in parts], _transport(x),
                    group=group)
    return parts


class _SumForward(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        _count("all_reduce", x)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _SumBackward.apply(grad, ctx.group), None


class _SumBackward(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _SumForward.apply(grad, ctx.group), None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last axis forward, this rank's block of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(_all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return _SliceLast.apply(grad, ctx.group), None


class _SliceLast(torch.autograd.Function):
    """This rank's block of the last axis forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[-1] // dist.get_world_size(group)
        return x.narrow(-1, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherLast.apply(grad, ctx.group), None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` for every peer to use alike (the
    gradient passes through); ``x`` itself without a group."""
    return x if group is None else _SumForward.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The peers' blocks of the last axis, joined in rank order."""
    return x if group is None else _GatherLast.apply(x, group)


def slice_last(x: torch.Tensor, group) -> torch.Tensor:
    """This peer's block of the last axis of a replicated ``x``; its
    gradient is the peers' blocks gathered, the adjoint of the slice."""
    return x if group is None else _SliceLast.apply(x, group)


def gather_time(x: torch.Tensor) -> torch.Tensor:
    """The time peers' frames (axis 1) of a time-sharded batch, joined
    into whole sequences (JAX's ``local_rows`` of a ``('data', 'time')``
    array); ``x`` itself without a time axis. No gradient."""
    group = time_group()
    if group is None:
        return x
    return torch.cat(_all_gather(x, group), dim=1)


# ---------------------------------------------------------------------------
# parameter sharding rules (model parallelism)
#
# Everything is replicated except the two parameter matrices whose size
# grows with sequence length (SURVEY.md §5.7: the discriminator's
# flatten->Dense(1) head is O(seq)):
#   * generator input projection kernel  (noise_dim, w0*noise_dim): shard the
#     output features,
#   * discriminator head kernel (seq/strides^5 * 5u, 1): shard the input
#     features (a sum over 'model' joins the partial dot products).
# The rules read Flax names and Flax (din, dout) kernel shapes: the port's
# Dense stores its weight (dout, din), and convert.flax_param_path names
# each of its parameters.
# ---------------------------------------------------------------------------

def param_spec(path: Sequence[str], shape: Sequence[int]) -> tuple:
    """The partition spec of the Flax parameter at ``path`` of ``shape``:
    ``(MODEL_AXIS, None)`` for a head's input rows, ``(None, MODEL_AXIS)``
    for an input projection's output columns, ``()`` replicated."""
    names = list(path)
    if "kernel" not in names or len(shape) != 2:
        return ()
    if any(n.startswith("Dense_") for n in names):
        din, dout = shape
        if dout == 1:            # discriminator head: shard input features
            return (MODEL_AXIS, None)
        if dout >= 8 * din:      # generator/mlp input projection
            return (None, MODEL_AXIS)
    return ()


def state_shardings(params: Dict[tuple, Sequence[int]],
                    model_parallelism: int) -> Dict[tuple, tuple]:
    """Each Flax path's spec over a model axis of ``model_parallelism``:
    :func:`param_spec`, replicated when the model axis is 1 or does not
    divide the sharded dimension (JAX's own fallback)."""
    out = {}
    for path, shape in params.items():
        spec = () if model_parallelism == 1 else param_spec(path, shape)
        for dim, axis in enumerate(spec):
            if axis is not None and shape[dim] % model_parallelism:
                spec = ()
                break
        out[path] = spec
    return out


def _flax_shape(name: str, shape: Sequence[int]) -> tuple:
    """A port Dense weight ``(dout, din)`` is the Flax kernel ``(din,
    dout)``; other parameters keep their shapes for the rules' sake."""
    return tuple(shape)[::-1] if name.endswith("weight") and \
        len(shape) == 2 else tuple(shape)


def model_shardings(nets: Dict[str, torch.nn.Module], model: str,
                    model_parallelism: int) -> Dict[str, tuple]:
    """``"net/parameter"`` -> spec for every parameter of ``nets``
    (``{"generator": ..., "discriminator": ...}``) of a ``model`` run,
    through the Flax names of :func:`~calciumgan_tpu_torch.convert.
    flax_param_path`."""
    from calciumgan_tpu_torch import convert
    out = {}
    for kind, net in nets.items():
        paths = {}
        for name, p in net.named_parameters():
            path = convert.flax_param_path(kind, name, model)
            paths[path] = (name, _flax_shape(name, p.shape))
        specs = state_shardings({k: s for k, (_, s) in paths.items()},
                                model_parallelism)
        for path, spec in specs.items():
            out[f"{kind}/{paths[path][0]}"] = spec
    return out


def shard_models(nets: Dict[str, torch.nn.Module], model: str,
                 group) -> Dict[str, tuple]:
    """Cut every parameter :func:`model_shardings` shards over ``group``
    down to this rank's block, in place, before an optimizer holds them;
    a Dense module then computes through :func:`sharded_dense`. Returns
    ``"net/parameter"`` -> shard shape of the sharded ones."""
    from calciumgan_tpu_torch.models.base import Dense
    n, i = dist.get_world_size(group), dist.get_rank(group)
    shards = {}
    specs = model_shardings(nets, model, n)
    for kind, net in nets.items():
        for module_name, module in net.named_modules():
            if not isinstance(module, Dense):
                continue
            spec = specs[f"{kind}/{module_name}.weight"]
            if not spec:
                continue
            # Flax kernel dim 0 (input rows) is the weight's dim 1
            dim = 1 if spec[0] == MODEL_AXIS else 0
            with torch.no_grad():
                size = module.weight.shape[dim] // n
                module.weight = torch.nn.Parameter(module.weight.narrow(
                    dim, i * size, size).clone())
                if dim == 0:
                    size = module.bias.shape[0] // n
                    module.bias = torch.nn.Parameter(module.bias.narrow(
                        0, i * size, size).clone())
                    shards[f"{kind}/{module_name}.bias"] = tuple(
                        module.bias.shape)
            module.model_shard = (dim, group)
            shards[f"{kind}/{module_name}.weight"] = tuple(
                module.weight.shape)
    return shards


def sharded_parameters(module: torch.nn.Module) -> Dict[str, tuple]:
    """``name`` -> ``(dim, group)`` of each parameter of ``module`` that
    :func:`shard_models` cut, ``dim`` the axis its shards join on."""
    out = {}
    for prefix, sub in module.named_modules():
        shard = getattr(sub, "model_shard", None)
        if shard is None:
            continue
        dim, group = shard
        stem = f"{prefix}." if prefix else ""
        out[f"{stem}weight"] = (dim, group)
        if dim == 0:
            out[f"{stem}bias"] = (0, group)
    return out


def whole_shapes(module: torch.nn.Module) -> Dict[str, tuple]:
    """``name`` -> the shape of each parameter of ``module`` in the whole
    model: a shard's (:func:`sharded_parameters`) with the axis its shards
    join on times its group's size. No collective."""
    cut = sharded_parameters(module)
    out = {}
    for name, p in module.named_parameters():
        shape = list(p.shape)
        if name in cut:
            dim, group = cut[name]
            shape[dim] *= dist.get_world_size(group)
        out[name] = tuple(shape)
    return out


def whole_parameters(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``name`` -> each parameter of ``module`` whole and detached, a shard
    gathered over its group (:func:`gather_shard`: a collective that every
    peer of the group joins, whether it writes or not)."""
    cut = sharded_parameters(module)
    return {name: gather_shard(p, *cut[name]) if name in cut
            else p.detach() for name, p in module.named_parameters()}


def gather_shard(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor of a shard cut by :func:`shard_models`."""
    return torch.cat(_all_gather(t.detach(), group), dim=dim)


def shard_of(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of a whole tensor, as :func:`shard_models` cut
    it."""
    size = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * size, size).clone()


def sharded_dense(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, dtype: torch.dtype, dim: int,
                  group) -> torch.Tensor:
    """A Dense layer over a model-sharded weight, in the module's compute
    ``dtype``. Output columns (``dim`` 0 of the ``(out, in)`` weight): the
    replicated ``x`` times this rank's columns, all-gathered; ``x``'s
    gradient, this rank's partial product, is summed over the group (the
    mlp critic's first layer: the penalty and the generator take their
    gradients through it). Input rows (``dim`` 1): the replicated ``x``'s
    block of this rank times its rows, the float32 partial products summed
    over the group, then the (replicated) bias."""
    if dim == 0:
        y = torch.nn.functional.linear(
            _SumBackward.apply(x, group).to(dtype), weight.to(dtype))
        return gather_last(y + bias.to(dtype), group)
    part = torch.nn.functional.linear(slice_last(x, group).to(dtype),
                                      weight.to(dtype))
    return sum_over(part.float(), group).to(dtype) + bias.to(dtype)
