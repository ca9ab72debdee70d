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
