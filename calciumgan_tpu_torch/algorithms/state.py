"""Train state (counterpart of ``calciumgan_tpu/algorithms/state.py``).

The JAX package keeps the whole state in one immutable pytree; here each
net is its module, its Adam optimizer (optax's ``adam(lr, eps=1e-7)``:
``betas=(0.9, 0.999)`` unless the config's ``adam_beta1``/``adam_beta2``
say otherwise, epsilon outside the square root, as Keras has it) and its
update count, all updated in place. The optional generator EMA is a
copy of the generator's parameters, updated after each generator step and
never fed back into training (``calciumgan_tpu/algorithms/gan.py:56-64,
97-103``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import tracing


@dataclasses.dataclass
class NetState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0  # optimizer updates taken


@dataclasses.dataclass
class GANState:
    generator: NetState
    discriminator: NetState
    # parameter name -> EMA tensor (None when --ema is 0)
    ema: Optional[Dict[str, torch.Tensor]] = None


def make_net_state(module: nn.Module, learning_rate: float,
                   betas: Tuple[float, float] = (0.9, 0.999)) -> NetState:
    return NetState(module, torch.optim.Adam(
        module.parameters(), lr=learning_rate, betas=betas, eps=1e-7))


def apply_updates(net: NetState, grads) -> None:
    """One Adam step of ``net`` with ``grads`` (one per parameter, in
    ``parameters()`` order). In a parallel rank the gradients are first
    averaged over the data axis (summed over a time axis first), in one
    flattened all-reduce (:func:`~calciumgan_tpu_torch.parallel.mesh.
    gradient_mean`), so every rank applies the same bytes and the replicas
    stay equal bit for bit; a model-sharded parameter's gradient, Adam
    moments and update are its shard's.
    (DDP's reducer would not see them: the steps take their gradients with
    ``torch.autograd.grad``, and the gradient penalty differentiates
    twice.) It runs as the span ``step/update``."""
    with tracing.span("step/update"):
        grads = mesh_lib.gradient_mean(grads)
        for p, g in zip(net.module.parameters(), grads):
            p.grad = g
        net.optimizer.step()
        net.optimizer.zero_grad(set_to_none=True)
        net.step += 1
