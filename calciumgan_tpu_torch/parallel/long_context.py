"""Long-context WGAN-GP: training over a time-sharded (context-parallel)
layout (counterpart of ``calciumgan_tpu/parallel/long_context.py``).

Trains the UNSEGMENTED long sequence by running the sequence-parallel
generator and discriminator (:mod:`.seq_parallel`) inside the port's
standard WGAN-GP: :class:`LongContextWGAN_GP` subclasses it and swaps only
the two module hooks (``GAN.gen``, ``GAN.dis``, as the JAX class swaps
``gen_apply`` / ``dis_apply``), so the critic loop, the gradient penalty's
double backward (through the halo exchange and its adjoint), the Adam
updates, the logs and the semantics (the same real batch for every critic
step, one phase shift per discriminator call and layer) are the standard
step's. Three quantities span the whole sequence and are summed over the
time group: the head's partial products (:mod:`.seq_parallel`), the
penalty's per-sample squared gradient norm (:meth:`LongContextWGAN_GP.
sequence_sum`) and, in :func:`~.mesh.gradient_mean`, every parameter's
gradient, of which a rank holds its frames' share. A masked mean's sums
and weights are every rank's (:func:`~.mesh.metric_sum`), so each frame
and each row counts once.

Layout ``(data, time)`` (:func:`~.mesh.create_time_mesh`): a rank holds its
rows of each batch and its frames of them. Supported: ``wgan-gp``, the
1-D ``calciumgan`` model, layer_norm or no norm; every layer's shard must
cover its halo, so this is for sequences of tens of thousands of frames.
"""

from __future__ import annotations

import contextlib

import torch

from calciumgan_tpu_torch.algorithms.wgan_gp import WGAN_GP
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.parallel.seq_parallel import (
    seq_parallel_discriminator, seq_parallel_generator)


@contextlib.contextmanager
def _parameters(module: torch.nn.Module, values: dict):
    """``module``'s parameters hold ``values`` (by name) inside the block;
    no gradient may be taken."""
    params = dict(module.named_parameters())
    saved = {name: params[name].data for name in values}
    try:
        for name, value in values.items():
            params[name].data = value
        yield
    finally:
        for name, data in saved.items():
            params[name].data = data


class LongContextWGAN_GP(WGAN_GP):
    """WGAN-GP whose generator and discriminator passes run
    sequence-parallel over ``group`` (the time group; None runs them on
    whole sequences in one process). Construct via
    :func:`make_long_context_algorithm`."""

    def __init__(self, config, generator, discriminator, group):
        super().__init__(config, generator, discriminator)
        if getattr(config, "batch_norm", False):
            raise ValueError(
                "long-context training supports layer_norm only (BatchNorm "
                "statistics would need cross-shard reduction)")
        self.group = group
        self.m = int(config.m)

    def gen(self, noise, draws, *, training: bool):
        return seq_parallel_generator(self.generator, noise, self.group)

    def dis(self, x, draws, *, training: bool):
        # one shift per discriminator call per shuffled layer, shared
        # across the batch (the reference's semantics); as the JAX class,
        # none in evaluation
        shifts = (draws.shifts(self.m, 4) if training and self.m > 0
                  else None)
        return seq_parallel_discriminator(self.discriminator, x, shifts,
                                          self.group)

    def sample(self, state, noise):
        """The rank's frames of the generator's output for evaluation and
        sampling: the EMA params when the state has them."""
        with torch.no_grad():
            if state.ema is None:
                return self.gen(noise, None, training=False)
            with _parameters(self.generator, state.ema):
                return self.gen(noise, None, training=False)

    def sequence_sum(self, x):
        return mesh_lib.sum_over(x, self.group)


def make_long_context_algorithm(config, generator, discriminator,
                                group=None):
    """The :class:`LongContextWGAN_GP` of a ``config`` over ``group``
    (default: this rank's time group), with the JAX package's
    refusals."""
    if config.algorithm != "wgan-gp":
        raise ValueError(
            f"long-context training supports wgan-gp (got "
            f"{config.algorithm!r})")
    if config.model != "calciumgan":
        raise ValueError(
            f"long-context training supports the 1-D calciumgan model (got "
            f"{config.model!r})")
    group = mesh_lib.time_group() if group is None else group
    return LongContextWGAN_GP(config, generator, discriminator, group)
