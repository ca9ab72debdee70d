"""What the port's data-parallel tests run inside their ranks, and the
replay of recorded draws. Imports nothing of JAX, so a spawned rank starts
with ``torch`` and the port alone (``test_torch_parallel.py``,
``test_torch_multiprocess.py``; ``torch_step_helpers`` takes
:class:`Replay` from here)."""

import functools
import time

import numpy as np
import torch
import torch.distributed as dist

from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch import train
from calciumgan_tpu_torch.algorithms import get_algorithm
from calciumgan_tpu_torch.algorithms.gan import Draws, ShardDraws
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.models.base import BatchNorm
from calciumgan_tpu_torch.parallel import mesh as mesh_lib


class Replay:
    """The methods of ``Draws``, returning recorded JAX draws."""

    def __init__(self, draws):
        self.queue = {k: list(v) for k, v in draws.items()}

    def noise(self, n, noise_dim):
        z = self.queue["noise"].pop(0)
        assert z.shape == (n, noise_dim)
        return torch.from_numpy(z)

    def alpha(self, n):
        return torch.from_numpy(self.queue["alpha"].pop(0).reshape(n))

    def shifts(self, m, count):
        return [int(self.queue["shift"].pop(0)) for _ in range(count)]

    def dropout(self, shape, rate):
        keep = self.queue["dropout"].pop(0)
        assert keep.shape == tuple(shape) and keep.dtype == np.bool_
        return torch.from_numpy(keep)

    def left(self):
        return {k: len(v) for k, v in self.queue.items() if v}


def build(sizes: dict):
    """The port's algorithm and a fresh state for a configuration, with the
    weights of ``torch_step_helpers.make_pair`` (seed 0)."""
    cfg = Config(**sizes)
    algo = get_algorithm(cfg, *get_models(
        cfg, rng=torch.Generator().manual_seed(0)))
    return algo, algo.init_state()


def _tensors(state) -> dict:
    """Parameters, buffers and Adam's first moments of both nets, by
    name, on the host."""
    out = {}
    for name in ("generator", "discriminator"):
        net = getattr(state, name)
        for n, p in net.module.named_parameters():
            out[f"{name}/{n}"] = p.detach().numpy().copy()
            moment = net.optimizer.state[p]["exp_avg"]
            out[f"{name}/moment/{n}"] = moment.numpy().copy()
        for n, b in net.module.named_buffers():
            out[f"{name}/buffer/{n}"] = b.numpy().copy()
    return out


def step(sizes: dict, real: np.ndarray, draws) -> dict:
    """One train step from the seeded weights: its logs and tensors."""
    algo, state = build(sizes)
    logs = algo.train_step(state, torch.from_numpy(real), draws)
    return dict(logs={k: float(v) for k, v in logs.items()},
                tensors=_tensors(state))


def rank_step(sizes: dict, real: np.ndarray, recorded=None,
              seed: int = 0, counter: int = 0) -> dict:
    """In a rank: :func:`step` on this rank's rows of the global ``real``
    batch and its share of the global draws (``recorded`` JAX draws, else
    ``Draws(seed, counter)``); the collective calls made."""
    torch.set_num_threads(1)
    mesh_lib.collectives.clear()
    rank, world = mesh_lib.process_index(), mesh_lib.process_count()
    local = np.ascontiguousarray(mesh_lib.rows_of(real, rank, world))
    base = (Replay(recorded) if recorded is not None
            else Draws(seed, counter, "cpu"))
    out = step(sizes, local, ShardDraws(base, rank, world, len(local)))
    out["left"] = base.left() if recorded is not None else {}
    out["collectives"] = dict(mesh_lib.collectives)
    return out


def evaluate(sizes: dict, real: np.ndarray, mask: np.ndarray, draws) -> dict:
    """One evaluation step of the seeded weights: its logs."""
    algo, state = build(sizes)
    _, logs = algo.eval_step(state, torch.from_numpy(real), draws,
                             torch.from_numpy(mask))
    return {k: float(v) for k, v in logs.items()}


def rank_evaluate(sizes: dict, real: np.ndarray, mask: np.ndarray,
                  seed: int, counter: int) -> dict:
    """In a rank: :func:`evaluate` on this rank's rows of ``real`` and
    ``mask`` with its share of ``Draws(seed, counter)``."""
    torch.set_num_threads(1)
    rank, world = mesh_lib.process_index(), mesh_lib.process_count()
    local = np.ascontiguousarray(mesh_lib.rows_of(real, rank, world))
    return evaluate(sizes, local, np.ascontiguousarray(
        mesh_lib.rows_of(mask, rank, world)),
        ShardDraws(Draws(seed, counter, "cpu"), rank, world, len(local)))


def rank_gather(real: np.ndarray) -> np.ndarray:
    """In a rank: every rank's rows of ``real`` gathered from their ranks."""
    rank, world = mesh_lib.process_index(), mesh_lib.process_count()
    local = torch.from_numpy(np.ascontiguousarray(
        mesh_lib.rows_of(real, rank, world)))
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=mesh_lib.data_group())
    return torch.cat(parts).numpy()


def rank_train(config, layout, num_samples=None):
    """In a rank: ``train.main`` over ``layout``, the surrogate set cut to
    ``num_samples`` rows."""
    torch.set_num_threads(1)
    if num_samples is not None:
        train.generate_surrogate_dataset = functools.partial(
            train.generate_surrogate_dataset, num_samples=num_samples)
    return train.main(config, mesh=layout)


def rank_generate(config, num_samples: int, out: str, batch_size: int):
    """In a rank: ``generate.main`` on the host; the shard it wrote."""
    torch.set_num_threads(1)
    return generate_mod.main(config, num_samples=num_samples, out=out,
                             batch_size=batch_size, device="cpu")


def rank_jobs(jobs):
    """In a rank: each ``(key, function, args)`` of ``jobs`` in turn; their
    results by key."""
    return {key: fn(*args) for key, fn, args in jobs}


def rank_fail(which):
    """In a rank: rank ``which`` raises; every other rank (each rank when
    ``which`` is None) hangs."""
    if mesh_lib.process_index() == which:
        raise ValueError(f"rank {which} fails")
    time.sleep(3600)


# ---- model and time axes ---------------------------------------------------

def layout(model: int = 1, time: int = 1, slices: int = 1):
    """The ``(data, model)`` or ``(data, time)`` layout of this group's
    ranks on the host, the data axis taking the rest; with ``slices``, a
    ``(slice, data, model)`` one, the data axis taking the rest of a
    slice."""
    world = mesh_lib.process_count()
    if time > 1:
        return mesh_lib.create_time_mesh(world // time, time, ["cpu"] * world)
    return mesh_lib.create_mesh(world // (model * slices), model,
                                ["cpu"] * world, slices=slices)


def rank_batch_norm_peers(x: np.ndarray, model: int) -> dict:
    """In a rank of a ``(data, model)`` layout: a BatchNorm training pass
    over its data index's rows of ``x`` (N, C, W), scaled by ``1 + 2**-20``
    on every model peer but the first, as activations a peer computes on
    another GPU may differ in the last bits: the running statistics."""
    mesh_lib.init_groups(layout(model))
    rows = mesh_lib.rows_of(x, mesh_lib.data_index(), mesh_lib.data_extent())
    peer = mesh_lib.process_index() % model
    bn = BatchNorm(x.shape[1])
    bn(torch.from_numpy(np.ascontiguousarray(rows))
       * (1.0 + min(peer, 1) * 2.0 ** -20), training=True)
    return {n: b.numpy().copy() for n, b in bn.named_buffers()}


def whole_tensors(state) -> dict:
    """:func:`_tensors` and the generator's EMA (``ema/<name>``) with
    every model-sharded parameter, moment and average gathered whole (a
    collective over the model group)."""
    out = {}
    for name in ("generator", "discriminator"):
        net = getattr(state, name)
        shards = mesh_lib.sharded_parameters(net.module)
        for n, p in net.module.named_parameters():
            moment = net.optimizer.state[p]["exp_avg"]
            if n in shards:
                p, moment = (mesh_lib.gather_shard(t, *shards[n])
                             for t in (p, moment))
            out[f"{name}/{n}"] = p.detach().numpy().copy()
            out[f"{name}/moment/{n}"] = moment.numpy().copy()
        for n, b in net.module.named_buffers():
            out[f"{name}/buffer/{n}"] = b.numpy().copy()
    shards = mesh_lib.sharded_parameters(state.generator.module)
    for n, t in (state.ema or {}).items():
        if n in shards:
            t = mesh_lib.gather_shard(t, *shards[n])
        out[f"ema/{n}"] = t.detach().numpy().copy()
    return out


def _parallel_setup(sizes, real, model, time, recorded, seed, counter,
                    slices=1):
    mesh_lib.init_groups(layout(model, time, slices))
    cfg = Config(**dict(sizes, seed=0))
    algo, shards = train.build_algorithm(cfg, torch.device("cpu"))
    di, de = mesh_lib.data_index(), mesh_lib.data_extent()
    local = mesh_lib.time_frames(mesh_lib.rows_of(real, di, de))
    base = (Replay(recorded) if recorded is not None
            else Draws(seed, counter, "cpu"))
    return (algo, shards, torch.from_numpy(np.ascontiguousarray(local)),
            base, ShardDraws(base, di, de, len(local)))


def rank_parallel_step(sizes: dict, real: np.ndarray, model: int = 1,
                       time: int = 1, recorded=None, seed: int = 0,
                       counter: int = 0, slices: int = 1) -> dict:
    """In a rank of a ``(data, model)`` or ``(data, time)`` layout (under
    ``slices`` slices of the data axis): one train step of the seeded
    weights on its rows (and frames) of ``real`` with its share of the
    draws; the logs, whole tensors, shard shapes, collective calls and the
    rows it trained on."""
    torch.set_num_threads(1)
    mesh_lib.collectives.clear()
    algo, shards, local, base, draws = _parallel_setup(
        sizes, real, model, time, recorded, seed, counter, slices)
    rows = local.numpy().copy()
    state = algo.init_state()
    logs = algo.train_step(state, local, draws)
    out = dict(logs={k: float(v) for k, v in logs.items()},
               collectives=dict(mesh_lib.collectives), shards=shards,
               left=base.left() if recorded is not None else {}, rows=rows)
    out["tensors"] = whole_tensors(state)
    return out


def rank_layer_tables(sizes: dict):
    """In a rank of a model-2 layout: ``train.layer_table`` and
    ``train.count_params`` of both nets of the seeded weights, cut to this
    rank's shards; the shard shapes."""
    mesh_lib.init_groups(layout(model=2))
    algo, shards = train.build_algorithm(Config(**dict(sizes, seed=0)),
                                         torch.device("cpu"))
    return {name: (train.layer_table(net), train.count_params(net))
            for name, net in (("generator", algo.generator),
                              ("discriminator", algo.discriminator))}, shards


def rank_parallel_eval(sizes: dict, real: np.ndarray, mask: np.ndarray,
                       model: int = 1, time: int = 1, recorded=None,
                       seed: int = 0, counter: int = 0) -> dict:
    """In a rank: one evaluation step of the seeded weights (as
    :func:`rank_parallel_step`) under ``mask``; its logs and the whole
    generated batch."""
    torch.set_num_threads(1)
    algo, _, local, base, draws = _parallel_setup(
        sizes, real, model, time, recorded, seed, counter)
    di, de = mesh_lib.data_index(), mesh_lib.data_extent()
    fake, logs = algo.eval_step(algo.init_state(), local, draws,
                                torch.from_numpy(np.ascontiguousarray(
                                    mesh_lib.rows_of(mask, di, de))))
    return dict(logs={k: float(v) for k, v in logs.items()},
                fake=mesh_lib.gather_time(fake).numpy())


# ---- the time axis's primitives --------------------------------------------

def _time_group():
    """The whole group as one time axis (data 1 x time P)."""
    mesh_lib.init_groups(layout(time=mesh_lib.process_count()))
    return mesh_lib.time_group()


def _my_frames(x: np.ndarray, axis: int = 1) -> torch.Tensor:
    index, extent = mesh_lib.process_index(), mesh_lib.process_count()
    moved = np.moveaxis(x, axis, 1)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        mesh_lib.frames_of(moved, index, extent), 1, axis)))


def _whole(t: torch.Tensor, axis: int = 1) -> np.ndarray:
    """Every rank's frames (``axis``) of ``t`` joined; the frames are the
    time axis of the layout :func:`_time_group` made."""
    t = t.detach().movedim(axis, 1).contiguous()
    return mesh_lib.gather_time(t).movedim(1, axis).numpy()


def rank_halo_conv(x: np.ndarray, weight: np.ndarray, stride: int,
                   transpose: bool, cotangent: np.ndarray) -> dict:
    """In a rank: the halo conv (or transposed conv) of its frames of the
    NCW ``x`` with the port's ``weight``, and the gradient of ``sum(out *
    cotangent)`` with respect to ``x`` and the weight (the weight's summed
    over the ranks); the outputs and input gradients whole."""
    from calciumgan_tpu_torch.parallel import halo_conv
    torch.set_num_threads(1)
    group = _time_group()
    local = _my_frames(x, axis=2).requires_grad_(True)
    w = torch.from_numpy(weight).requires_grad_(True)
    fn = (halo_conv.halo_conv_transpose1d_local if transpose
          else halo_conv.halo_conv1d_local)
    out = fn(local, w, stride, group)
    (out * _my_frames(cotangent, axis=2)).sum().backward()
    w_grad = mesh_lib.all_reduce_sum(w.grad, group=group)
    return dict(out=_whole(out, 2), x_grad=_whole(local.grad, 2),
                w_grad=w_grad.numpy())


def rank_phase_shuffle(x: np.ndarray, shift: int, m: int,
                       cotangent: np.ndarray) -> dict:
    """In a rank: the halo phase shuffle of its frames of the NCW ``x``,
    and its input gradient under ``cotangent``, both whole."""
    from calciumgan_tpu_torch.parallel import seq_parallel
    torch.set_num_threads(1)
    group = _time_group()
    local = _my_frames(x, axis=2).requires_grad_(True)
    out = seq_parallel.halo_phase_shuffle_local(local, shift, m, group)
    (out * _my_frames(cotangent, axis=2)).sum().backward()
    return dict(out=_whole(out, 2), x_grad=_whole(local.grad, 2))


def _calciumgan(sizes: dict, net: str, state_dict):
    cfg = Config(**sizes)
    nets = dict(zip(("generator", "discriminator"), get_models(
        cfg, rng=torch.Generator().manual_seed(0))))
    module = nets[net]
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in state_dict.items()})
    return module


def rank_seq_discriminator(sizes: dict, state_dict, x: np.ndarray,
                           shifts) -> np.ndarray:
    """In a rank: the sequence-parallel critic's scores of ``x`` (its
    frames of it) with ``shifts`` (None: no phase shuffle)."""
    from calciumgan_tpu_torch.parallel import seq_parallel
    torch.set_num_threads(1)
    group = _time_group()
    dis = _calciumgan(sizes, "discriminator", state_dict)
    with torch.no_grad():
        return seq_parallel.seq_parallel_discriminator(
            dis, _my_frames(x), shifts, group).numpy()


def rank_seq_generator(sizes: dict, state_dict, z: np.ndarray
                       ) -> np.ndarray:
    """In a rank: the sequence-parallel generator's output for ``z``,
    whole."""
    from calciumgan_tpu_torch.parallel import seq_parallel
    torch.set_num_threads(1)
    group = _time_group()
    gen = _calciumgan(sizes, "generator", state_dict)
    with torch.no_grad():
        out = seq_parallel.seq_parallel_generator(
            gen, torch.from_numpy(z), group)
    return _whole(out)


def rank_critic_loss(sizes: dict, state_dict, real: np.ndarray,
                     fake: np.ndarray, alpha: np.ndarray) -> dict:
    """In a rank: ``-mean D(real) + mean D(fake) + 10 gp`` through the
    sequence-parallel critic, the penalty's gradient norm over the whole
    sequence, and every parameter's gradient summed over the ranks."""
    from calciumgan_tpu_torch.parallel import seq_parallel
    torch.set_num_threads(1)
    group = _time_group()
    dis = _calciumgan(sizes, "discriminator", state_dict)

    def apply(x):
        return seq_parallel.seq_parallel_discriminator(dis, x, None, group)

    real_l, fake_l = _my_frames(real), _my_frames(fake)
    a = torch.from_numpy(alpha)
    x_hat = (a * real_l + (1 - a) * fake_l).requires_grad_(True)
    g, = torch.autograd.grad(apply(x_hat).sum(), x_hat, create_graph=True)
    norm = torch.sqrt(mesh_lib.sum_over(
        g.reshape(g.shape[0], -1).square().sum(1), group) + 1e-12)
    gp = ((norm - 1.0) ** 2).mean()
    loss = -apply(real_l).mean() + apply(fake_l).mean() + 10.0 * gp
    names = [n for n, _ in dis.named_parameters()]
    grads = torch.autograd.grad(loss, list(dis.parameters()))
    summed = mesh_lib.gradient_mean(grads)  # data extent 1: the time sum
    return dict(loss=float(loss), grads={
        n: t.numpy().copy() for n, t in zip(names, summed)})
