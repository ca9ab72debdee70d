"""WaveGAN's training loop: ``WGAN_GP.train_step(state, real, draws)`` of
the port's ``wavegan_paper`` back to back on batches that
``DeviceStore.batch`` gathers from the mix's windows, as the port's
``train.train_epoch`` calls them, in one process on one GPU.

The port's ``Config`` carries the configuration's Adam betas (0.5, 0.9 in
the paper); the weights are the paper's layout in Flax's, drawn as
:mod:`h100bench.inputs` draws the 1-D model's
(:mod:`h100bench.reference.wavegan`); the windows are the harness's AR(1)
calcium mapped to [-1, 1], the range of the generator's tanh. The checked
readings are ``loops/train2d.py``'s, the critic's first gradient among
them, and the reference follows them
(:mod:`h100bench.reference.wgan_gp_wave`); the window is
:mod:`h100bench.closed_loop`'s.
"""

from __future__ import annotations

import dataclasses
import sys
from time import time

import torch

from h100bench import closed_loop, inputs, program, work_wave
from h100bench.loops import train as train_loop
from h100bench.loops import train2d
from h100bench.reference import model as ref_model
from h100bench.reference import wavegan
from h100bench.reference import wgan_gp_wave


def port_config(cfg: dict, mix: dict, seed: int):
    """The port's ``Config`` of the cell, with its Adam betas."""
    return dataclasses.replace(program.port_config(cfg, mix, seed),
                               adam_beta1=cfg["adam_beta1"],
                               adam_beta2=cfg["adam_beta2"])


def model_weights(cfg: dict, seed: int, device) -> tuple:
    """WaveGAN's generator and critic weights of run ``seed``."""
    return (inputs.weights(wavegan.generator_shapes(cfg), seed, 1, device),
            inputs.weights(wavegan.critic_shapes(cfg), seed, 2, device))


def windows(cfg: dict, mix: dict, seed: int, device) -> torch.Tensor:
    """The mix's ``(rows, T, c)`` AR(1) windows of run ``seed`` on
    [-1, 1]."""
    return inputs.ar1_calcium(mix["rows"], cfg["sequence_length"],
                              cfg["num_channels"], mix["data"], seed,
                              device) * 2.0 - 1.0


class WaveTrainer(train2d.Trainer2D):
    """The 2-D loop's training object (its checked readings keep the
    critic's first gradient), built for WaveGAN on one device."""

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


def reference_readings(cfg, mix, seed, device, cast=ref_model.identity_cast,
                       rows=None) -> dict:
    """The reference's readings of the checked steps, ``first_grad`` among
    them: the same weights, rows and draws. ``cast`` and ``rows`` give the
    control and the half-batch fault."""
    gen, dis = model_weights(cfg, seed, device)
    gen0 = {k: v.clone() for k, v in gen.items()}
    dis0 = {k: v.clone() for k, v in dis.items()}
    for p in (*gen.values(), *dis.values()):
        p.requires_grad_(True)
    betas = (cfg["adam_beta1"], cfg["adam_beta2"])
    opt_g = wgan_gp_wave.Adam(gen, cfg["learning_rate"], betas)
    opt_d = wgan_gp_wave.Adam(dis, cfg["learning_rate"], betas, keep=True)
    data = windows(cfg, mix, seed, device)
    out = {"losses": []}
    for k in range(mix["checked_steps"]):
        idx = inputs.step_rows(seed, k, mix["rows"], mix["batch_size"])
        out["losses"].append(wgan_gp_wave.train_step(
            gen, dis, opt_g, opt_d, data[torch.as_tensor(idx)],
            inputs.Draws(seed, k, device), cfg, cast, rows))
        if k == 0:
            out["grad"] = train_loop._norms(opt_g.m, opt_d.m)
    out["change"] = train_loop._norms(
        {k: v - gen0[k] for k, v in gen.items()},
        {k: v - dis0[k] for k, v in dis.items()})
    out["first_grad"] = {f"discriminator/{k}": v
                         for k, v in opt_d.first.items()}
    return out


def run(cell: dict, seed: int, seconds: float, traced: bool, started: float,
        device: str = "cuda", fault=None) -> dict:
    """One run of the WaveGAN cell: the window, then the reference's check
    on the same device."""
    cfg, mix = cell["config_data"], cell["traffic_data"]
    dev = closed_loop.one_chip(cell, device)
    stage = closed_loop.stages(started)
    stage("imports")
    trainer = WaveTrainer(cfg, mix, seed, dev, fault, stage)
    lead = closed_loop.window(trainer, mix, seconds, traced, started, stage)
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    begin = time()
    ref = reference_readings(cfg, mix, seed, dev)
    print(f"reference {time() - begin:.3f} s", file=sys.stderr, flush=True)
    return closed_loop.result(
        lead, mix, train2d.numbers(lead["readings"], ref),
        work_wave.train_step_flops(cfg, mix["batch_size"]))
