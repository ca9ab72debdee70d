"""The training loop: ``WGAN_GP.train_step(state, real, draws)`` back to
back on batches that ``DeviceStore.batch`` gathers, as the port's
``train.train_epoch`` calls them, in one process on one GPU or in one rank
a GPU over NCCL (``parallel/launch.launch``, ``mesh.init_groups``).

Set-up builds the algorithm and its state once, loads the harness's
weights, and drives that same state through the mix's ``checked_steps``
(whose losses, first Adam moments and parameter changes the reference then
follows) and ``warm_steps`` before the window. The window runs steps until
one step past the step boundary at which the host clock has passed
``--seconds``; CUDA events at the step boundaries time each step on the
device timeline (rank 0's in a group). Rank 0 makes that decision and
tells the others over a gloo group without waiting for it, so every rank
runs the same steps and no rank's host waits for another's between steps.
Each rank reports the forbidden modules it loaded (``run.FORBIDDEN``).
"""

from __future__ import annotations

import statistics
import sys
from time import perf_counter, time

import torch

from h100bench import compare, inputs, program, trace, work
from h100bench.run import forbidden_modules
from h100bench.reference import model as ref_model
from h100bench.reference import wgan_gp as ref_wgan_gp


def _join(cfg, mix, devices):
    """This process's rank, device and the gloo group the window's end is
    told over (None alone); a group's layout as ``train.main`` makes it."""
    import torch.distributed as dist
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    rank = dist.get_rank() if dist.is_initialized() else 0
    ctl = None
    if len(devices) > 1:
        config = program.port_config(cfg, mix, 0)
        mesh_lib.init_groups(train.layout(config, devices))
        ctl = dist.new_group(backend="gloo")
    return rank, torch.device(devices[rank]), ctl


class Trainer:
    """One rank's training object for one seed: the port's algorithm and
    state built once with the harness's weights, the rank's rows in a
    ``DeviceStore``, and the step the checked steps and the window call."""

    def __init__(self, cfg, mix, seed, devices, rank, device, fault=None,
                 stage=lambda name: None):
        from calciumgan_tpu_torch import train
        from calciumgan_tpu_torch.data import pipeline
        from calciumgan_tpu_torch.parallel import mesh as mesh_lib
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.rank, self.device, self.world = rank, device, len(devices)
        config = program.port_config(cfg, mix, seed)
        self.local = mesh_lib.local_batch_size(config.batch_size)
        self.algo, _ = train.build_algorithm(config, device)
        stage("models")
        self.gen_w, self.dis_w = inputs.model_weights(cfg, seed, device)
        program.load_weights(self.algo, cfg["model"], self.gen_w, self.dis_w)
        self.state = self.algo.init_state()
        stage("weights")
        data = inputs.ar1_calcium(mix["rows"], cfg["sequence_length"],
                                  cfg["num_channels"], mix["data"], seed,
                                  device)
        self.store = pipeline.DeviceStore(
            data[rank::self.world].cpu().numpy(), device)
        stage("data")
        if fault is not None:
            fault(self.algo)

    def step(self, k: int):
        from calciumgan_tpu_torch.algorithms import gan
        real = self.store.batch(inputs.step_rows(
            self.seed, k, self.mix["rows"] // self.world, self.local))
        draws = gan.shard_draws(inputs.Draws(self.seed, k, self.device),
                                self.rank, self.world, self.local)
        return self.algo.train_step(self.state, real, draws)

    def checked(self) -> dict:
        """The checked steps and this rank's readings of them."""
        model = self.cfg["model"]
        readings = {"losses": []}
        for k in range(self.mix["checked_steps"]):
            logs = self.step(k)
            readings["losses"].append({n: float(logs[n])
                                       for n in compare.LOSSES})
            if k == 0:
                readings["grad"] = program.first_moments(self.state, model)
        readings["change"] = program.changes(self.state, model, self.gen_w,
                                             self.dis_w)
        return readings


def _rank(cfg, mix, seed, seconds, traced, devices, started,
          fault=None) -> dict:
    """One rank's set-up, checked steps and window (rank 0 of 1 without a
    group), on the GPUs or, in the tests, on the host. ``fault`` breaks the
    program underneath (tests only)."""
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    import torch.distributed as dist
    rank, device, ctl = _join(cfg, mix, devices)

    def stage(name: str) -> None:
        if rank == 0:
            print(f"setup {name} at {time() - started:.3f} s",
                  file=sys.stderr, flush=True)

    stage("imports and group")
    trainer = Trainer(cfg, mix, seed, devices, rank, device, fault, stage)
    readings = trainer.checked()
    stage("checked steps")
    step = trainer.step
    k = mix["checked_steps"] + mix["warm_steps"]
    for j in range(mix["checked_steps"], k):
        step(j)
    bytes_before = sum(mesh_lib.collective_bytes.values())

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    if ctl is not None:
        dist.barrier(group=ctl)
    setup_s = time() - started
    marks = [_mark(cuda)]
    t0 = perf_counter()
    n = 0
    # Rank 0 decides at each step boundary whether the window has run its
    # time; the other ranks learn it over the gloo group while the next
    # step runs, so no rank waits for the host of another between steps,
    # and every rank stops one step after the decision.
    stop, told = torch.zeros(1), None
    while True:
        if told is not None:
            told.wait()
        if stop[0]:
            break
        if rank == 0:
            stop[0] = float(perf_counter() - t0 >= seconds and n >= 2)
        if ctl is not None:
            told = dist.broadcast(stop, 0, group=ctl, async_op=True)
        with torch.profiler.record_function("h100bench/train_step"):
            step(k)
        k, n = k + 1, n + 1
        marks.append(_mark(cuda))
    if cuda:
        torch.cuda.synchronize(device)
    window_s = perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bytes_per_step = (sum(mesh_lib.collective_bytes.values())
                      - bytes_before) / n
    window = None
    if traced:  # steady steps after the window, under the profiler
        tracing = trace.Window(device)
        for j in range(k, k + mix["traced_steps"]):
            with torch.profiler.record_function("h100bench/train_step"):
                step(j)
        window = tracing.stop()
    out = {
        "rank": rank, "steps": n, "window_s": window_s, "setup_s": setup_s,
        "step_ms": [_elapsed_ms(a, b) for a, b in zip(marks, marks[1:])],
        "memory_peak_bytes": peak, "bytes_per_step": bytes_per_step,
        "trace": window, "readings": readings,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "forbidden": forbidden_modules(),
    }
    del trainer, step
    if cuda:
        torch.cuda.empty_cache()
    return out


def _mark(cuda: bool):
    """A step boundary: a CUDA event on the device's timeline, else the
    host clock."""
    if not cuda:
        return perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _elapsed_ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (
        (b - a) * 1e3)


def checked_readings(cfg, mix, seeds, devices, fault=None) -> list:
    """One rank's readings of the checked steps for each of ``seeds``, each
    seed's training object built and freed in turn (calibration)."""
    rank, device, _ = _join(cfg, mix, devices)
    out = []
    for seed in seeds:
        trainer = Trainer(cfg, mix, seed, devices, rank, device, fault)
        out.append(trainer.checked())
        del trainer
        torch.cuda.empty_cache()
    return out


def reference_readings(cfg, mix, seed, device, cast=ref_model.identity_cast,
                       rows=None) -> dict:
    """The reference's readings of the checked steps at the global batch:
    the same weights, rows and draws. ``cast`` and ``rows`` give the
    control and the half-batch fault."""
    world = mix.get("data_parallelism", 1)
    local = mix["batch_size"] // world
    gen, dis = inputs.model_weights(cfg, seed, device)
    gen0 = {k: v.clone() for k, v in gen.items()}
    dis0 = {k: v.clone() for k, v in dis.items()}
    for p in (*gen.values(), *dis.values()):
        p.requires_grad_(True)
    opt_g = ref_wgan_gp.Adam(gen, cfg["learning_rate"])
    opt_d = ref_wgan_gp.Adam(dis, cfg["learning_rate"])
    data = inputs.ar1_calcium(mix["rows"], cfg["sequence_length"],
                              cfg["num_channels"], mix["data"], seed, device)
    out = {"losses": []}
    for k in range(mix["checked_steps"]):
        idx = inputs.step_rows(seed, k, mix["rows"] // world, local)
        real = torch.cat([data[r + world * torch.as_tensor(idx)]
                          for r in range(world)])
        out["losses"].append(ref_wgan_gp.train_step(
            gen, dis, opt_g, opt_d, real, inputs.Draws(seed, k, device),
            cfg, cast, rows))
        if k == 0:
            out["grad"] = _norms(opt_g.m, opt_d.m)
    out["change"] = _norms({k: v - gen0[k] for k, v in gen.items()},
                           {k: v - dis0[k] for k, v in dis.items()})
    return out


def _norms(gen: dict, dis: dict) -> dict:
    return {f"{net}/{k}": float(torch.linalg.vector_norm(
        v.detach().double())) for net, leaves in (("generator", gen),
                                                  ("discriminator", dis))
            for k, v in leaves.items()}


def run(cell: dict, seed: int, seconds: float, traced: bool, started: float,
        device: str = "cuda", fault=None) -> dict:
    """One run of a training cell: the ranks' windows, then the reference's
    check in this process on the first device."""
    cfg, mix = cell["config_data"], cell["traffic_data"]
    world = mix.get("data_parallelism", 1)
    if world != cell["chips"]:
        raise ValueError(f"traffic {cell['traffic']} runs {world} ranks, "
                         f"the cell asks for {cell['chips']} chips")
    args = (cfg, mix, seed, seconds, traced)
    devices = ([f"cuda:{i}" for i in range(world)] if device == "cuda"
               else [device] * world)
    if world == 1:
        ranks = [_rank(*args, devices, started, fault)]
    else:
        from calciumgan_tpu_torch.parallel import launch
        ranks = launch.launch(_rank, devices,
                              "gloo" if device == "cpu" else "nccl",
                              args=(*args, devices, started, fault))
    lead = ranks[0]
    ref_device = torch.device(devices[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    begin = time()
    ref = reference_readings(cfg, mix, seed, ref_device)
    print(f"reference {time() - begin:.3f} s", file=sys.stderr, flush=True)
    numbers = {}
    for r in ranks:  # the worst rank's
        for name, value in compare.training_numbers(r["readings"],
                                                    ref).items():
            numbers[name] = max(numbers.get(name, 0.0), value)
    steps = lead["steps"]
    result = {
        "attempted": steps, "failed": 0, "numbers": numbers,
        "end_to_end": {
            "train_samples_per_s": steps * mix["batch_size"]
            / lead["window_s"],
            "train_step_p90_ms": statistics.quantiles(
                lead["step_ms"], n=10, method="inclusive")[-1],
            "setup_s": lead["setup_s"]},
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks),
        "device_kind": lead["device_kind"], "count": world,
        "forbidden": sorted({m for r in ranks for m in r["forbidden"]}),
        "context": {
            "steps": steps, "window_s": lead["window_s"],
            "step_flops": work.train_step_flops(cfg, mix["batch_size"]),
            "chips": world,
            "bytes_per_step": lead["bytes_per_step"],
            "traces": [r["trace"] for r in ranks]},
    }
    return result

