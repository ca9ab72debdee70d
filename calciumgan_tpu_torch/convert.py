"""Flax generator and discriminator parameters <-> the port's
``state_dict``s.

Flax names its submodules by class and order. The generator's (``Dense_0``,
``ConvTranspose_0..4``, ``Norm_i/LayerNorm_0``, ``Dense_1``) are the port's
:class:`~calciumgan_tpu_torch.models.calciumgan.Generator`'s ``dense_0``,
``conv_transpose.i``, ``norm.i``, ``dense_1``; the discriminator's
(``Conv_0..4``, ``Dense_0``) are the
:class:`~calciumgan_tpu_torch.models.calciumgan.Discriminator`'s ``conv.i``
and ``dense``. Layouts:

- Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``; the
  discriminator's ``Dense_0`` reads a time-major flatten in both packages,
  so ``(W*C, 1)`` -> ``(1, W*C)`` needs no permutation;
- ConvTranspose kernel ``(K, Cin, Cout)`` -> ``(Cin, Cout, K)`` with the K
  axis flipped: Flax does not flip its kernel (``transpose_kernel=False``),
  ``F.conv_transpose1d`` does;
- Conv kernel ``(K, Cin, Cout)`` -> ``(Cout, Cin, K)``, not flipped:
  ``F.conv1d`` is a correlation, as ``lax.conv`` is;
- LayerNorm ``scale``/``bias`` unchanged. A size-1 channel axis has no
  LayerNorm (``calciumgan_tpu/models/base.py:45-70``), so no entry.

The ``mlp`` model's two nets are ``Dense_0..4`` each, the port's
``dense_0..4`` (:mod:`calciumgan_tpu_torch.models.mlp`), kernels transposed;
its discriminator flattens time-major in both packages. Each function takes
the run's ``config.model`` and applies that model's rules.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = re.compile(r"Dense_(\d+)$")
_CONV_T = re.compile(r"ConvTranspose_(\d+)$")
_NORM = re.compile(r"Norm_(\d+)$")
_CONV = re.compile(r"Conv_(\d+)$")


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, np.float32, order="C"))


def _mlp_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Either net of the ``mlp`` model: ``Dense_i`` -> ``dense_i``."""
    out = {}
    for key, sub in params.items():
        if not (m := _DENSE.match(key)):
            raise KeyError(f"unexpected mlp parameter group {key!r}")
        out[f"dense_{m[1]}.weight"] = _tensor(np.asarray(sub["kernel"]).T)
        out[f"dense_{m[1]}.bias"] = _tensor(sub["bias"])
    return out


def _flax_mlp_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`_mlp_state_dict`."""
    params: dict = {}
    for name, tensor in state_dict.items():
        a = tensor.detach().cpu().float().numpy()
        module, field = name.rsplit(".", 1)
        if not module.startswith("dense_"):
            raise KeyError(f"unexpected state_dict entry {name!r}")
        group = params.setdefault(f"Dense_{module[len('dense_'):]}", {})
        if field == "weight":
            group["kernel"] = np.ascontiguousarray(a.T)
        else:
            group[field] = a
    return params


def generator_state_dict(params: Mapping, model: str = "calciumgan"
                         ) -> Dict[str, torch.Tensor]:
    """Flax generator params (nested dict of arrays) of a ``model`` net ->
    ``state_dict``."""
    if model == "mlp":
        return _mlp_state_dict(params)
    out = {}

    def put(name, array):
        out[name] = _tensor(array)

    for key, sub in params.items():
        if m := _DENSE.match(key):
            put(f"dense_{m[1]}.weight", np.asarray(sub["kernel"]).T)
            put(f"dense_{m[1]}.bias", sub["bias"])
        elif m := _CONV_T.match(key):
            kernel = np.asarray(sub["kernel"])
            put(f"conv_transpose.{m[1]}.weight",
                np.transpose(kernel, (1, 2, 0))[..., ::-1])
            put(f"conv_transpose.{m[1]}.bias", sub["bias"])
        elif m := _NORM.match(key):
            for norm_key, norm in sub.items():
                if norm_key != "LayerNorm_0":
                    raise KeyError(f"unsupported norm {key}/{norm_key}")
                put(f"norm.{m[1]}.scale", norm["scale"])
                put(f"norm.{m[1]}.bias", norm["bias"])
        else:
            raise KeyError(f"unexpected generator parameter group {key!r}")
    return out


def flax_generator_params(state_dict: Mapping[str, torch.Tensor],
                          model: str = "calciumgan") -> dict:
    """Inverse of :func:`generator_state_dict`."""
    if model == "mlp":
        return _flax_mlp_params(state_dict)
    params: dict = {}
    for name, tensor in state_dict.items():
        a = tensor.detach().cpu().float().numpy()
        module, field = name.rsplit(".", 1)
        if module.startswith("dense_"):
            group = f"Dense_{module[len('dense_'):]}"
            leaf = {"weight": "kernel"}.get(field, field)
            params.setdefault(group, {})[leaf] = (
                a.T if field == "weight" else a)
        elif module.startswith("conv_transpose."):
            group = f"ConvTranspose_{module.split('.')[1]}"
            if field == "weight":
                params.setdefault(group, {})["kernel"] = np.ascontiguousarray(
                    np.transpose(a[..., ::-1], (2, 0, 1)))
            else:
                params.setdefault(group, {})[field] = a
        elif module.startswith("norm."):
            group = f"Norm_{module.split('.')[1]}"
            params.setdefault(group, {}).setdefault("LayerNorm_0", {})[
                field] = a
        else:
            raise KeyError(f"unexpected state_dict entry {name!r}")
    return params


def discriminator_state_dict(params: Mapping, model: str = "calciumgan"
                             ) -> Dict[str, torch.Tensor]:
    """Flax discriminator params of a ``model`` net -> ``state_dict``."""
    if model == "mlp":
        return _mlp_state_dict(params)
    out = {}
    for key, sub in params.items():
        if m := _CONV.match(key):
            out[f"conv.{m[1]}.weight"] = _tensor(
                np.transpose(np.asarray(sub["kernel"]), (2, 1, 0)))
            out[f"conv.{m[1]}.bias"] = _tensor(sub["bias"])
        elif key == "Dense_0":
            out["dense.weight"] = _tensor(np.asarray(sub["kernel"]).T)
            out["dense.bias"] = _tensor(sub["bias"])
        else:
            raise KeyError(
                f"unexpected discriminator parameter group {key!r}")
    return out


def flax_discriminator_params(state_dict: Mapping[str, torch.Tensor],
                              model: str = "calciumgan") -> dict:
    """Inverse of :func:`discriminator_state_dict`."""
    if model == "mlp":
        return _flax_mlp_params(state_dict)
    params: dict = {}
    for name, tensor in state_dict.items():
        a = tensor.detach().cpu().float().numpy()
        module, field = name.rsplit(".", 1)
        if module.startswith("conv."):
            group = f"Conv_{module.split('.')[1]}"
            if field == "weight":
                a = np.ascontiguousarray(np.transpose(a, (2, 1, 0)))
        elif module == "dense":
            group = "Dense_0"
            if field == "weight":
                a = np.ascontiguousarray(a.T)
        else:
            raise KeyError(f"unexpected state_dict entry {name!r}")
        params.setdefault(group, {})[
            {"weight": "kernel"}.get(field, field)] = a
    return params
