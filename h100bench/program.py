"""The harness's side of the boundary with the program under test,
``calciumgan_tpu_torch``: its configuration built from a cell's files, the
harness's weights loaded into its modules through its own converter, and
readings of its state keyed by Flax path, as the reference keys its own.
The benchmark takes nothing else from the program but what the loops
drive."""

from __future__ import annotations

import numpy as np
import torch

from h100bench import inputs

# configuration keys that are the port's Config fields of the same name
CONFIG_FIELDS = ("model", "algorithm", "sequence_length", "num_neurons",
                 "num_channels", "noise_dim", "num_units", "kernel_size",
                 "strides", "m", "activation", "layer_norm", "batch_norm",
                 "mixed_precision", "n_critic", "gradient_penalty",
                 "learning_rate", "ema", "normalize", "signals_min",
                 "signals_max")


def port_config(cfg: dict, mix: dict, seed: int):
    from calciumgan_tpu_torch.config import Config
    return Config(
        **{k: cfg[k] for k in CONFIG_FIELDS},
        signal_shape=(cfg["sequence_length"], cfg["num_channels"]),
        batch_size=mix["batch_size"], train_size=mix.get("rows"),
        data_parallelism=mix.get("data_parallelism", 1),
        seed=inputs.derive(seed, 8), verbose=0)


def generator_variables(gen_w: dict) -> dict:
    """Flax generator variables, host arrays, as ``generate`` takes them."""
    return {"params": inputs.to_numpy_tree(gen_w), "batch_stats": {}}


def load_weights(algo, model_name: str, gen_w: dict, dis_w: dict) -> None:
    from calciumgan_tpu_torch import convert
    algo.generator.load_state_dict(convert.generator_state_dict(
        inputs.to_numpy_tree(gen_w), model_name))
    algo.discriminator.load_state_dict(convert.discriminator_state_dict(
        inputs.to_numpy_tree(dis_w), model_name))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def flax_arrays(net: str, named: dict, model_name: str) -> dict:
    """``{net/flax path: float64 array}`` of tensors named as the port's
    ``net`` names its parameters."""
    from calciumgan_tpu_torch import convert
    if net == "generator":
        tree = convert.flax_generator_variables(named, model_name)["params"]
    else:
        tree = convert.flax_discriminator_params(named, model_name)
    return {f"{net}/{k}": v for k, v in _flat(tree).items()}


def first_moments(state, model_name: str) -> dict:
    """Each leaf's norm of Adam's first moment."""
    out = {}
    for net in ("generator", "discriminator"):
        ns = getattr(state, net)
        named = {n: ns.optimizer.state[p].get("exp_avg",
                                              torch.zeros_like(p))
                 for n, p in ns.module.named_parameters()}
        out.update({k: float(np.linalg.norm(v)) for k, v in
                    flax_arrays(net, named, model_name).items()})
    return out


def changes(state, model_name: str, gen_w: dict, dis_w: dict) -> dict:
    """Each leaf's norm of its change from the harness's weights."""
    start = {f"generator/{k}": v for k, v in _flat(
        inputs.to_numpy_tree(gen_w)).items()}
    start.update({f"discriminator/{k}": v for k, v in _flat(
        inputs.to_numpy_tree(dis_w)).items()})
    out = {}
    for net in ("generator", "discriminator"):
        named = {n: p.detach()
                 for n, p in getattr(state, net).module.named_parameters()}
        out.update({k: float(np.linalg.norm(v - start[k])) for k, v in
                    flax_arrays(net, named, model_name).items()})
    return out

