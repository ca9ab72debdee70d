"""The two ways into a data-parallel run: ranks this package starts on one
host (:func:`launch`), and a group ``torchrun`` started (:func:`join`, the
counterpart of the JAX CLI's ``--distributed`` and its
``jax.distributed.initialize()``).

:func:`launch` spawns one process per device with the ``spawn`` start
method (no rank inherits the caller's CUDA state). Each rank sets its CUDA
device before any other CUDA call, joins the group through a file store on
the local disk and runs the function; the caller gets every rank's result
in rank order. A rank that fails hands its exception back: the caller
kills the other ranks (which may wait in a collective for it) and raises
it. A rank that hangs makes the call raise ``TimeoutError`` after
``timeout`` seconds, its siblings killed with it. A training run's length
has no bound, so the CLI passes no ``timeout``: there ``GROUP_TIMEOUT``
bounds a hang. A rank that waits that long in a collective for a peer
fails (NCCL's watchdog ends its process), and the launcher then kills the
other ranks, the hung one too, and raises.

The backend is the caller's choice (``nccl`` for GPUs, ``gloo`` for the
host; gloo also takes CUDA tensors, through the host). There is no
fallback: a backend that fails to start fails the run.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from calciumgan_tpu_torch.parallel import mesh as mesh_lib

# how long a rank waits for its peers in a collective before it fails
GROUP_TIMEOUT = timedelta(minutes=30)


class RankFailed(RuntimeError):
    """The traceback of a rank's exception, chained under it."""


def _picklable(exc: BaseException) -> BaseException:
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def _rank(fn, args, rank, devices, backend, init_method, results):
    """One spawned rank: its device, the group, ``fn(*args)``, the result
    (or the exception and its traceback) on ``results``."""
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:  # host ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // len(devices)))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=len(devices),
                                timeout=GROUP_TIMEOUT)
        outcome = (rank, True, fn(*args))
    except BaseException as exc:  # handed to the caller, which raises it
        outcome = (rank, False, (_picklable(exc), traceback.format_exc()))
    results.put(outcome)
    if outcome[1] and dist.is_initialized():
        dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence, backend: str, args=(),
           timeout: Optional[float] = None,
           store: Optional[str] = None) -> list:
    """``fn(*args)`` in one spawned rank per entry of ``devices`` (rank
    ``i`` on ``devices[i]``) over ``backend``; their results in rank order.
    ``store`` is the path of the file store (a fresh one in a temporary
    directory by default; it must not exist yet). ``fn`` and ``args`` must
    pickle."""
    devices = [str(d) for d in devices]
    scratch = None
    if store is None:
        scratch = tempfile.mkdtemp(prefix="calciumgan-ranks-")
        store = os.path.join(scratch, "store")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, name=f"rank-{r}", args=(
        fn, tuple(args), r, devices, backend,
        f"file://{os.path.abspath(store)}", results))
        for r in range(len(devices))]
    deadline = None if timeout is None else time.monotonic() + timeout
    done = {}
    try:
        for p in procs:
            p.start()
        while len(done) < len(procs):
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_lib.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    missing = [r for r in range(len(procs)) if r not in done]
                    raise TimeoutError(
                        f"ranks {missing} did not finish within {timeout} s")
                gone = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if gone:
                    try:  # a result may still be on its way
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue_lib.Empty:
                        raise RuntimeError(
                            f"rank {gone[0]} exited with code "
                            f"{procs[gone[0]].exitcode} and no result")
                else:
                    continue
            if not ok:
                exc, text = payload
                raise exc from RankFailed(f"rank {rank} of {len(procs)} "
                                          f"failed:\n{text}")
            done[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    return [done[r] for r in range(len(procs))]


def join(device="cuda") -> list:
    """``--distributed``: join the group ``torchrun`` set up from its
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): rank ``i`` on ``cuda:LOCAL_RANK`` over NCCL, or on the
    host over gloo for a CPU ``device``. Returns every rank's device in rank
    order (one all-gather)."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed: {', '.join(missing)} not set "
                           f"(start the ranks with torchrun)")
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            timeout=GROUP_TIMEOUT)
    devices = [None] * dist.get_world_size()
    mesh_lib.collectives["all_gather_object"] += 1
    dist.all_gather_object(devices, str(device))
    return devices


def leave() -> None:
    """Leave the process group this process joined, if any."""
    mesh_lib.forget_groups()
    if dist.is_initialized():
        dist.destroy_process_group()
