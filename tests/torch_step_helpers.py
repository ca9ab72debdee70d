"""Shared by the port's step parity tests: the tiny configurations, the
shared weights, and the capture and replay of the JAX package's random
draws (see ``test_torch_train_step.py``, ``test_torch_mlp.py``,
``test_torch_calciumgan2d.py``, ``test_torch_batch_norm.py`` and
``test_torch_parallel.py``). The replaying object, :class:`Replay`, lives
in ``torch_rank_helpers``, which a spawned rank imports without JAX."""

import collections
import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu.algorithms import get_algorithm as jax_get_algorithm
from calciumgan_tpu.algorithms.state import GANState, make_net_state
from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.models import calciumgan as jax_calciumgan
from calciumgan_tpu.models import calciumgan2d as jax_calciumgan2d
from calciumgan_tpu.models import get_models as jax_get_models
from calciumgan_tpu.models import mlp as jax_mlp
from calciumgan_tpu.ops.phase_shuffle import _shift_axis as jax_shift_axis
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.algorithms import get_algorithm
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import get_models
from torch_rank_helpers import Replay  # noqa: F401  (the steps' replay)


def tiny(**kw):
    d = dict(model="calciumgan", algorithm="wgan-gp", sequence_length=64,
             num_neurons=6, num_channels=6, signal_shape=(64, 6),
             noise_dim=8, num_units=4, kernel_size=4, strides=2, m=2,
             epochs=1, batch_size=8, n_critic=2, normalize=True,
             layer_norm=True, signals_min=0.0, signals_max=1.0,
             learning_rate=1e-5)
    d.update(kw)
    return d


def tiny_mlp(**kw):
    """The surrogate set's shape: sequences of 6 frames, 2 neurons."""
    return tiny(**dict(dict(model="mlp", sequence_length=6, num_neurons=2,
                            num_channels=2, signal_shape=(6, 2),
                            dropout=0.2), **kw))


def tiny_2d(**kw):
    """A ``--conv2d`` dataset's shape: (64 frames, 6 neurons, 1 channel),
    units 2 (``tests/test_models.py:49-90``)."""
    return tiny(**dict(dict(model="calciumgan2d", signal_shape=(64, 6, 1),
                            num_channels=1, num_units=2, noise_dim=4, n=2),
                       **kw))


class Recorder:
    """The JAX step's draws, by kind, in execution order."""

    def __init__(self):
        self.draws = collections.defaultdict(list)

    def __call__(self, kind):
        return lambda v: self.draws[kind].append(np.array(v))

    def take(self):
        jax.effects_barrier()
        draws, self.draws = dict(self.draws), collections.defaultdict(list)
        return draws


def sizes_of(**kw):
    """The tiny sizes of ``kw``'s model: :func:`tiny_mlp`'s for
    ``model="mlp"``, :func:`tiny_2d`'s for ``model="calciumgan2d"``, else
    :func:`tiny`'s, updated with ``kw``."""
    return {"mlp": tiny_mlp, "calciumgan2d": tiny_2d}.get(
        kw.get("model"), tiny)(**kw)


def make_pair(rec, **kw):
    """The port's algorithm and state, and the JAX algorithm (its noise and
    alpha draws recorded) with a state holding the same weights and
    BatchNorm running statistics; the weights are the port's glorot draws,
    so no Flax ``init`` is compiled. The sizes are :func:`sizes_of`'s."""
    sizes = sizes_of(**kw)
    cfg = Config(**sizes)
    algo = get_algorithm(cfg, *get_models(
        cfg, rng=torch.Generator().manual_seed(0)))
    jcfg = JaxConfig(**sizes)
    jalgo = jax_get_algorithm(jcfg, *jax_get_models(jcfg))
    gen = convert.flax_generator_variables(algo.generator.state_dict(),
                                           cfg.model)
    dis = convert.flax_discriminator_params(
        algo.discriminator.state_dict(), cfg.model)
    jstate = GANState(generator=make_net_state(gen, jalgo.tx_gen),
                      discriminator=make_net_state({"params": dis},
                                                   jalgo.tx_dis))
    get_noise = jalgo.get_noise

    def noise(key, n):
        z = get_noise(key, n)
        jax.debug.callback(rec("noise"), z, ordered=True)
        return z

    def interpolate(key, real, fake):  # as WGAN_GP.interpolate draws
        shape = (real.shape[0],) + (1,) * (real.ndim - 1)
        alpha = jax.random.uniform(key, shape, jnp.float32)
        jax.debug.callback(rec("alpha"), alpha, ordered=True)
        return alpha * real + (1.0 - alpha) * fake

    jalgo.get_noise = noise
    jalgo.interpolate = interpolate
    return algo, algo.init_state(), jalgo, jstate


def recording_dropout(rec):
    """Flax's ``nn.Dropout`` with its keep mask recorded: the same name (so
    the same ``dropout`` RNG path), the same draw, the same arithmetic."""

    class Dropout(nn.Dropout):

        @nn.compact
        def __call__(self, inputs, deterministic=None, rng=None):
            deterministic = nn.merge_param(
                "deterministic", self.deterministic, deterministic)
            if self.rate == 0.0 or deterministic:
                return inputs
            keep_prob = 1.0 - self.rate
            keep = jax.random.bernoulli(self.make_rng("dropout"),
                                        p=keep_prob, shape=inputs.shape)
            jax.debug.callback(rec("dropout"), keep, ordered=True)
            return jax.lax.select(keep, inputs / keep_prob,
                                  jnp.zeros_like(inputs))

    return Dropout


class _Linen:
    """``flax.linen`` as ``calciumgan_tpu.models.mlp`` reads it at call
    time, with another ``Dropout``."""

    def __init__(self, dropout):
        self.Dropout = dropout

    def __getattr__(self, name):
        return getattr(nn, name)


@contextlib.contextmanager
def recording():
    """A :class:`Recorder` of the JAX discriminators' phase shifts, drawn
    exactly as ``calciumgan_tpu.ops.phase_shuffle.phase_shuffle`` and
    ``phase_shuffle_2d`` draw them (the 2-D one's time shift, then its
    neuron shift), and of the JAX mlp model's dropout masks, while the
    context lasts."""
    rec = Recorder()

    def shift_axis(x, key, m, axis):
        shift = jax.random.randint(key, (), -m, m + 1)
        jax.debug.callback(rec("shift"), shift, ordered=True)
        return jax_shift_axis(x, shift, m, axis)

    def phase_shuffle(x, key, m, axis=1):
        return x if m == 0 else shift_axis(x, key, m, axis)

    def phase_shuffle_2d(x, key, m, n, w_axis=1, c_axis=2):
        kw, kc = jax.random.split(key)
        if m > 0:
            x = shift_axis(x, kw, m, w_axis)
        if n > 0:
            x = shift_axis(x, kc, n, c_axis)
        return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_calciumgan, "phase_shuffle", phase_shuffle)
        mp.setattr(jax_calciumgan2d, "phase_shuffle_2d", phase_shuffle_2d)
        mp.setattr(jax_mlp, "nn", _Linen(recording_dropout(rec)))
        yield rec


def real_batch(n=8, seed=0, shape=(64, 6)):
    return np.random.default_rng(seed).random((n,) + shape).astype(
        np.float32)
