"""The 2-D model's inputs, as :mod:`h100bench.inputs` and
:mod:`h100bench.program` make the 1-D model's: the port's ``Config`` with
the signal shape ``(T, N, C)`` and the neuron shift ``n``, the generator's
and critic's Flax weights of a run's seed, and the AR(1) windows laid out
``(T, N, 1)``."""

from __future__ import annotations

import dataclasses

import torch

from h100bench import inputs, program
from h100bench.reference import model2d


def port_config(cfg: dict, mix: dict, seed: int):
    """The port's ``Config`` of the 2-D cell: signals ``(T, N, C)``."""
    return dataclasses.replace(
        program.port_config(cfg, mix, seed), n=cfg["n"],
        signal_shape=(cfg["sequence_length"], cfg["num_neurons"],
                      cfg["num_channels"]))


def model_weights(cfg: dict, seed: int, device) -> tuple:
    """The 2-D generator's and critic's Flax weights of run ``seed``, drawn
    as :func:`h100bench.inputs.model_weights` draws the 1-D model's."""
    return (inputs.weights(model2d.generator_shapes(cfg), seed, 1, device),
            inputs.weights(model2d.critic_shapes(cfg), seed, 2, device))


def windows(cfg: dict, mix: dict, seed: int, device) -> torch.Tensor:
    """The mix's ``(rows, T, N, 1)`` AR(1) windows of run ``seed``."""
    return inputs.ar1_calcium(mix["rows"], cfg["sequence_length"],
                              cfg["num_neurons"], mix["data"], seed,
                              device)[..., None]
