"""The 2-D model's training loop: ``WGAN_GP.train_step(state, real, draws)``
of ``calciumgan2d`` back to back on batches of ``(B, T, N, 1)`` windows
that ``DeviceStore.batch`` gathers, as the port's ``train.train_epoch``
calls them, in one process on one GPU.

It drives the 1-D loop's :class:`~h100bench.loops.train.Trainer` steps and
checked readings, on the port's ``Config`` with the signal shape ``(T, N,
C)`` and the neuron shift ``n``, the 2-D model's Flax weights
(:mod:`h100bench.reference.model2d`) and the AR(1) windows laid out ``(T,
N, 1)`` (:mod:`h100bench.inputs2d`). Set-up runs the mix's
``checked_steps`` (which the 2-D reference then follows,
:mod:`h100bench.reference.wgan_gp2d`) and ``warm_steps``;
the window runs steps until one step past the step boundary at which the
host clock has passed ``--seconds``, each step timed by CUDA events at its
boundaries; a traced run then profiles ``traced_steps`` more. The window is
the 1-D loop's, less its ranks.

Besides the 1-D loop's readings, both sides keep the critic's first
gradient: that of the first critic update of the first checked step, on
the harness's weights before any Adam step. Its gap, ``first_grad_gap``
(:func:`first_grad_gap`), is what tells this model's bf16 program from the
fp8 control and the half batch: over three whole steps its rounding grows
until ``grad_gap`` and ``loss_gap`` cannot (``PERF.md`` section 2).
"""

from __future__ import annotations

import statistics
import sys
from time import perf_counter, time

import numpy as np
import torch

from h100bench import compare, inputs, program, trace, work2d
from h100bench.inputs2d import model_weights, port_config, windows
from h100bench.loops import train as train_loop
from h100bench.reference import model as ref_model
from h100bench.reference import wgan_gp2d
from h100bench.reference import wgan_gp as ref_wgan_gp
from h100bench.run import forbidden_modules


class Trainer2D(train_loop.Trainer):
    """The 1-D loop's training object, built for the 2-D model on one
    device."""

    def __init__(self, cfg, mix, seed, device, fault=None,
                 stage=lambda name: None):
        from calciumgan_tpu_torch import train
        from calciumgan_tpu_torch.data import pipeline
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.rank, self.device, self.world = 0, torch.device(device), 1
        self.local = mix["batch_size"]
        self.algo, _ = train.build_algorithm(port_config(cfg, mix, seed),
                                             self.device)
        stage("models")
        self.gen_w, self.dis_w = model_weights(cfg, seed, self.device)
        program.load_weights(self.algo, cfg["model"], self.gen_w, self.dis_w)
        self.state = self.algo.init_state()
        stage("weights")
        self.store = pipeline.DeviceStore(
            windows(cfg, mix, seed, self.device).cpu().numpy(), self.device)
        stage("data")
        if fault is not None:
            fault(self.algo)

    def checked(self) -> dict:
        """The 1-D loop's readings of the checked steps, and ``first_grad``:
        the critic's gradient at its first Adam step, ``{discriminator/flax
        path: float64 array}``, taken by a hook before that step."""
        critic = self.state.discriminator
        first = {}

        def record(optimizer, args, kwargs) -> None:
            if not first:
                first.update(program.flax_arrays(
                    "discriminator",
                    {n: p.grad for n, p in critic.module.named_parameters()},
                    self.cfg["model"]))

        hook = critic.optimizer.register_step_pre_hook(record)
        try:
            readings = super().checked()
        finally:
            hook.remove()
        readings["first_grad"] = first
        return readings


class _FirstGradAdam(ref_wgan_gp.Adam):
    """The reference's Adam, keeping the gradients of its first update as
    ``{discriminator/flax path: float64 array}``."""

    first = None

    def update(self, params: dict, grads: dict) -> None:
        if self.first is None:
            self.first = {f"discriminator/{k}": g.detach().double().cpu()
                          .numpy() for k, g in grads.items()}
        super().update(params, grads)


def first_grad_gap(prog: dict, ref: dict) -> float:
    """By the worst leaf of the critic, the norm of the gap between the two
    sides' first gradients, over the larger of the leaf's reference norm
    and the critic's median leaf's. Leaves under ``compare.SILENT_LEAF`` of
    that median are left out, as :mod:`h100bench.compare` leaves them out
    (the output bias, whose gradient cancels between real and fake rows).
    A leaf that is not finite makes the gap NaN; one that the program
    never handed to Adam, inf."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return float(np.max([
        np.linalg.norm(prog[k] - ref[k]) / max(n, med) if k in prog
        else np.inf for k, n in norms.items()
        if n >= compare.SILENT_LEAF * med]))


def numbers(prog: dict, ref: dict) -> dict:
    """:func:`compare.training_numbers` and ``first_grad_gap``."""
    return dict(compare.training_numbers(prog, ref),
                first_grad_gap=first_grad_gap(prog["first_grad"],
                                              ref["first_grad"]))


def _window(cfg, mix, seed, seconds, traced, device, started,
            fault=None) -> dict:
    """Set-up, checked steps, warm steps, the window and the traced steps
    on ``device`` (the GPU, or the host in the tests). ``fault`` breaks the
    program underneath (tests only)."""
    def stage(name: str) -> None:
        print(f"setup {name} at {time() - started:.3f} s", file=sys.stderr,
              flush=True)

    stage("imports")
    trainer = Trainer2D(cfg, mix, seed, device, fault, stage)
    readings = trainer.checked()
    stage("checked steps")
    k = mix["checked_steps"] + mix["warm_steps"]
    for j in range(mix["checked_steps"], k):
        trainer.step(j)
    cuda = trainer.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(trainer.device)
    setup_s = time() - started
    marks = [train_loop._mark(cuda)]
    t0 = perf_counter()
    n, stop = 0, False
    while not stop:  # one step past the boundary that passes ``seconds``
        stop = perf_counter() - t0 >= seconds and n >= 2
        with torch.profiler.record_function("h100bench/train_step"):
            trainer.step(k)
        k, n = k + 1, n + 1
        marks.append(train_loop._mark(cuda))
    if cuda:
        torch.cuda.synchronize(trainer.device)
    window_s = perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(trainer.device) if cuda else 0
    window = None
    if traced:  # steady steps after the window, under the profiler
        tracing = trace.Window(trainer.device)
        for j in range(k, k + mix["traced_steps"]):
            with torch.profiler.record_function("h100bench/train_step"):
                trainer.step(j)
        window = tracing.stop()
    out = {
        "steps": n, "window_s": window_s, "setup_s": setup_s,
        "step_ms": [train_loop._elapsed_ms(a, b)
                    for a, b in zip(marks, marks[1:])],
        "memory_peak_bytes": peak, "trace": window, "readings": readings,
        "device_kind": (torch.cuda.get_device_name(trainer.device) if cuda
                        else "cpu"),
    }
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    return out


def reference_readings(cfg, mix, seed, device, cast=ref_model.identity_cast,
                       rows=None) -> dict:
    """The 2-D reference's readings of the checked steps, ``first_grad``
    among them: the same weights, rows and draws. ``cast`` and ``rows``
    give the control and the half-batch fault."""
    gen, dis = model_weights(cfg, seed, device)
    gen0 = {k: v.clone() for k, v in gen.items()}
    dis0 = {k: v.clone() for k, v in dis.items()}
    for p in (*gen.values(), *dis.values()):
        p.requires_grad_(True)
    opt_g = ref_wgan_gp.Adam(gen, cfg["learning_rate"])
    opt_d = _FirstGradAdam(dis, cfg["learning_rate"])
    data = windows(cfg, mix, seed, device)
    out = {"losses": []}
    for k in range(mix["checked_steps"]):
        idx = inputs.step_rows(seed, k, mix["rows"], mix["batch_size"])
        out["losses"].append(wgan_gp2d.train_step(
            gen, dis, opt_g, opt_d, data[torch.as_tensor(idx)],
            inputs.Draws(seed, k, device), cfg, cast, rows))
        if k == 0:
            out["grad"] = train_loop._norms(opt_g.m, opt_d.m)
    out["change"] = train_loop._norms(
        {k: v - gen0[k] for k, v in gen.items()},
        {k: v - dis0[k] for k, v in dis.items()})
    out["first_grad"] = opt_d.first
    return out


def run(cell: dict, seed: int, seconds: float, traced: bool, started: float,
        device: str = "cuda", fault=None) -> dict:
    """One run of the 2-D training cell: the window, then the reference's
    check on the same device."""
    cfg, mix = cell["config_data"], cell["traffic_data"]
    if cell["chips"] != 1 or mix.get("data_parallelism", 1) != 1:
        raise ValueError(f"{cell['name']}: the 2-D loop runs on one chip")
    dev = torch.device("cuda:0" if device == "cuda" else device)
    lead = _window(cfg, mix, seed, seconds, traced, dev, started, fault)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    begin = time()
    ref = reference_readings(cfg, mix, seed, dev)
    print(f"reference {time() - begin:.3f} s", file=sys.stderr, flush=True)
    steps = lead["steps"]
    return {
        "attempted": steps, "failed": 0,
        "numbers": numbers(lead["readings"], ref),
        "end_to_end": {
            "train_samples_per_s": steps * mix["batch_size"]
            / lead["window_s"],
            "train_step_p90_ms": statistics.quantiles(
                lead["step_ms"], n=10, method="inclusive")[-1],
            "setup_s": lead["setup_s"]},
        "memory_peak_bytes": lead["memory_peak_bytes"],
        "device_kind": lead["device_kind"], "count": 1,
        "forbidden": forbidden_modules(),
        "context": {
            "steps": steps, "window_s": lead["window_s"],
            "step_flops": work2d.train_step_flops(cfg, mix["batch_size"]),
            "chips": 1, "bytes_per_step": 0.0,
            "traces": [lead["trace"]], "traced_steps": mix["traced_steps"]},
    }
