"""The training loop with its batches streamed from host memory, as the
port's ``train.train_epoch`` runs them under ``--device_store off`` (and
under ``auto`` when the signals outgrow ``--device_store_mb``): batches
gathered and pinned on the host by a ``DevicePrefetcher``'s thread, two
batches ahead, copied on its side stream, the step's stream waiting for
each.

Each epoch starts a new prefetcher over its batches, as ``train_epoch``
does, so the first step of each epoch waits for its first batch to be
gathered, pinned and copied. The mix's epochs are 4 steps (512 rows, as
``sl2048-train``'s), so that wait falls on every fourth step.

The rows, their order, the draws and the checked readings are
``loops/train.py``'s on one chip, so the batches and losses are
``sl2048-train``'s bit for bit and the reference is its reference; only
the way in differs. The window is :mod:`h100bench.closed_loop`'s.
"""

from __future__ import annotations

import sys
from time import time

import torch

from h100bench import closed_loop, compare, inputs, work
from h100bench.loops import train as train_loop


class StreamedTrainer(train_loop.Trainer):
    """``loops/train.py``'s training object on one device, its rows in
    host memory behind a ``HostBatches`` source instead of a
    ``DeviceStore``. Steps are taken in order from 0."""

    def __init__(self, cfg, mix, seed, device, fault=None,
                 stage=lambda name: None):
        from calciumgan_tpu_torch.data import pipeline
        super().__init__(cfg, mix, seed, [str(device)], 0,
                         torch.device(device), fault, stage)
        self.source = pipeline.HostBatches(self.store.signals.cpu().numpy(),
                                           self.device)
        del self.store
        self.reals, self.next_step = None, 0

    def step(self, k: int):
        from calciumgan_tpu_torch.algorithms import gan
        from calciumgan_tpu_torch.data import pipeline
        if k != self.next_step:
            raise ValueError(f"step {k} asked for, {self.next_step} next")
        per = self.mix["rows"] // self.local
        if k % per == 0:  # a new prefetcher each epoch
            self.reals = pipeline.DevicePrefetcher(
                self.source, inputs.epoch_order(self.seed, k // per,
                                                self.mix["rows"],
                                                self.local)[k % per:])
        real = next(self.reals)
        self.next_step = k + 1
        draws = gan.shard_draws(inputs.Draws(self.seed, k, self.device), 0,
                                1, self.local)
        return self.algo.train_step(self.state, real, draws)


def run(cell: dict, seed: int, seconds: float, traced: bool, started: float,
        device: str = "cuda", fault=None) -> dict:
    """One run of the streamed cell: the window, then ``loops/train.py``'s
    reference check on the same device."""
    cfg, mix = cell["config_data"], cell["traffic_data"]
    dev = closed_loop.one_chip(cell, device)
    stage = closed_loop.stages(started)
    stage("imports")
    trainer = StreamedTrainer(cfg, mix, seed, dev, fault, stage)
    lead = closed_loop.window(trainer, mix, seconds, traced, started, stage)
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    begin = time()
    ref = train_loop.reference_readings(cfg, mix, seed, dev)
    print(f"reference {time() - begin:.3f} s", file=sys.stderr, flush=True)
    return closed_loop.result(
        lead, mix, compare.training_numbers(lead["readings"], ref),
        work.train_step_flops(cfg, mix["batch_size"]))
