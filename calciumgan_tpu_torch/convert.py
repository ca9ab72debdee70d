"""Flax generator and discriminator variables <-> the port's
``state_dict``s.

Flax names its submodules by class and order. The generator's (``Dense_0``,
``ConvTranspose_0..4``, ``Norm_i/BatchNorm_0``, ``Norm_i/LayerNorm_0``,
``Dense_1``) are the port's ``dense_0``, ``conv_transpose.i``,
``norm.i.batch_norm``, ``norm.i`` and ``dense_1`` in both the 1-D
:class:`~calciumgan_tpu_torch.models.calciumgan.Generator` and
:class:`~calciumgan_tpu_torch.models.calciumgan2d.Generator2D`; the
discriminators' (``Conv_0..4``, ``Dense_0``) are ``conv.i`` and ``dense``.
The ``calciumgan``, ``calciumgan2d`` and ``wavegan_paper`` rules are one
set, read off each kernel's rank (WaveGAN's generator has no ``Dense_1``
and no ``Norm_i``). Layouts:

- Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``; each
  discriminator's ``Dense_0`` reads a channels-last flatten in both
  packages, so ``(W*C, 1)`` -> ``(1, W*C)`` needs no permutation;
- ConvTranspose kernel ``(*K, Cin, Cout)`` -> ``(Cin, Cout, *K)`` flipped on
  every spatial axis: Flax does not flip its kernel
  (``transpose_kernel=False``), ``F.conv_transpose1d``/``2d`` do;
- Conv kernel ``(*K, Cin, Cout)`` -> ``(Cout, Cin, *K)``, not flipped:
  ``F.conv1d``/``2d`` are correlations, as ``lax.conv`` is;
- LayerNorm and BatchNorm ``scale``/``bias`` unchanged. A size-1 channel
  axis has no LayerNorm (``calciumgan_tpu/models/base.py:45-70``), so no
  entry;
- the BatchNorm running statistics, Flax's ``batch_stats`` collection
  (``Norm_i/BatchNorm_0/{mean, var}``), are the port's buffers
  ``norm.i.batch_norm.{mean, var}``.

A generator's variables are ``{"params": ..., "batch_stats": ...}`` as
``generator.apply`` takes them, ``batch_stats`` ``{}`` without BatchNorm.
Anything else, in either direction, raises ``KeyError``.

The ``mlp`` model's two nets are ``Dense_0..4`` each, the port's
``dense_0..4`` (:mod:`calciumgan_tpu_torch.models.mlp`), kernels transposed;
its discriminator flattens time-major in both packages. Each function takes
the run's ``config.model`` and applies that model's rules.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_DENSE = re.compile(r"Dense_(\d+)$")
_CONV_T = re.compile(r"ConvTranspose_(\d+)$")
_NORM = re.compile(r"Norm_(\d+)$")
_CONV = re.compile(r"Conv_(\d+)$")
_DENSE_MODULE = re.compile(r"dense_(\d+)$")
_CONV_MODELS = ("calciumgan", "calciumgan2d", "wavegan", "wavegan_paper")
_PARAM_FIELDS = ("weight", "bias")
_NORM_FIELDS = ("scale", "bias")
_STAT_FIELDS = ("mean", "var")


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, np.float32, order="C"))


def _check_model(model: str) -> None:
    if model != "mlp" and model not in _CONV_MODELS:
        raise KeyError(f"no conversion rules for model {model!r}")


def _split(name: str, fields) -> tuple:
    """``(module, field)`` of a ``state_dict`` entry whose field is one of
    ``fields``."""
    module, field = name.rsplit(".", 1)
    if field not in fields:
        raise KeyError(f"unexpected state_dict entry {name!r}")
    return module, field


def _mlp_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Either net of the ``mlp`` model: ``Dense_i`` -> ``dense_i``."""
    out = {}
    for key, sub in params.items():
        if not (m := _DENSE.match(key)):
            raise KeyError(f"unexpected mlp parameter group {key!r}")
        out[f"dense_{m[1]}.weight"] = _tensor(np.asarray(sub["kernel"]).T)
        out[f"dense_{m[1]}.bias"] = _tensor(sub["bias"])
    return out


def flax_param_path(net: str, name: str, model: str = "calciumgan"
                    ) -> tuple:
    """The Flax path (``("Dense_0", "kernel")``, ``("Norm_2",
    "LayerNorm_0", "scale")``, ...) of the ``state_dict`` entry ``name`` of
    a ``model`` run's ``net`` (``"generator"`` or ``"discriminator"``): the
    name map of the functions below, for rules that read Flax names."""
    _check_model(model)
    module, field = name.rsplit(".", 1)
    field = {"weight": "kernel"}.get(field, field)
    parts = module.split(".")
    if m := _DENSE_MODULE.match(module):
        return (f"Dense_{m[1]}", field)
    if net == "discriminator" and module == "dense":
        return ("Dense_0", field)
    if net == "discriminator" and parts[0] == "conv" and len(parts) == 2:
        return (f"Conv_{parts[1]}", field)
    if net == "generator" and parts[0] == "conv_transpose" \
            and len(parts) == 2:
        return (f"ConvTranspose_{parts[1]}", field)
    if net == "generator" and parts[0] == "norm" and len(parts) == 2:
        return (f"Norm_{parts[1]}", "LayerNorm_0", field)
    if net == "generator" and parts[0] == "norm" \
            and parts[2:] == ["batch_norm"]:
        return (f"Norm_{parts[1]}", "BatchNorm_0", field)
    raise KeyError(f"unexpected {net} state_dict entry {name!r}")


def _flax_mlp_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`_mlp_state_dict`."""
    params: dict = {}
    for name, tensor in state_dict.items():
        a = tensor.detach().cpu().float().numpy()
        module, field = _split(name, _PARAM_FIELDS)
        if not (m := _DENSE_MODULE.match(module)):
            raise KeyError(f"unexpected state_dict entry {name!r}")
        group = params.setdefault(f"Dense_{m[1]}", {})
        if field == "weight":
            group["kernel"] = np.ascontiguousarray(a.T)
        else:
            group[field] = a
    return params


def _conv_transpose_weight(kernel) -> np.ndarray:
    """Flax ``(*K, Cin, Cout)`` -> ``(Cin, Cout, *K)``, every K flipped."""
    kernel = np.asarray(kernel)
    nd = kernel.ndim - 2
    w = np.transpose(kernel, (nd, nd + 1, *range(nd)))
    return np.flip(w, tuple(range(2, 2 + nd)))


def _flax_conv_transpose_kernel(weight: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_conv_transpose_weight`."""
    nd = weight.ndim - 2
    w = np.flip(weight, tuple(range(2, 2 + nd)))
    return np.ascontiguousarray(np.transpose(w, (*range(2, 2 + nd), 0, 1)))


def _conv_weight(kernel) -> np.ndarray:
    """Flax ``(*K, Cin, Cout)`` -> ``(Cout, Cin, *K)``."""
    kernel = np.asarray(kernel)
    nd = kernel.ndim - 2
    return np.transpose(kernel, (nd + 1, nd, *range(nd)))


def _flax_conv_kernel(weight: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_conv_weight`."""
    nd = weight.ndim - 2
    return np.ascontiguousarray(np.transpose(weight, (*range(2, 2 + nd), 1,
                                                      0)))


def _norm_entries(index: str, group: Mapping, collection: str) -> dict:
    """One ``Norm_i`` group of the ``params`` or ``batch_stats``
    collection -> its ``state_dict`` entries."""
    out = {}
    for norm_key, norm in group.items():
        if collection == "params" and norm_key == "LayerNorm_0":
            prefix, fields = f"norm.{index}", _NORM_FIELDS
        elif norm_key == "BatchNorm_0":
            prefix = f"norm.{index}.batch_norm"
            fields = _NORM_FIELDS if collection == "params" else _STAT_FIELDS
        else:
            raise KeyError(f"unsupported norm {collection}/Norm_{index}/"
                           f"{norm_key}")
        if set(norm) != set(fields):
            raise KeyError(f"{collection}/Norm_{index}/{norm_key} holds "
                           f"{sorted(norm)}, expected {list(fields)}")
        out.update({f"{prefix}.{f}": _tensor(norm[f]) for f in fields})
    return out


def generator_state_dict(params: Mapping, model: str = "calciumgan",
                         batch_stats: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    """Flax generator params (nested dict of arrays) of a ``model`` net, and
    its ``batch_stats`` when it has BatchNorm, -> ``state_dict``."""
    _check_model(model)
    if model == "mlp":
        if batch_stats:
            raise KeyError("the mlp generator has no batch_stats")
        return _mlp_state_dict(params)
    out = {}
    for key, sub in params.items():
        if m := _DENSE.match(key):
            out[f"dense_{m[1]}.weight"] = _tensor(np.asarray(sub["kernel"]).T)
            out[f"dense_{m[1]}.bias"] = _tensor(sub["bias"])
        elif m := _CONV_T.match(key):
            out[f"conv_transpose.{m[1]}.weight"] = _tensor(
                _conv_transpose_weight(sub["kernel"]))
            out[f"conv_transpose.{m[1]}.bias"] = _tensor(sub["bias"])
        elif m := _NORM.match(key):
            out.update(_norm_entries(m[1], sub, "params"))
        else:
            raise KeyError(f"unexpected generator parameter group {key!r}")
    for key, sub in (batch_stats or {}).items():
        if not (m := _NORM.match(key)):
            raise KeyError(f"unexpected generator batch_stats group {key!r}")
        out.update(_norm_entries(m[1], sub, "batch_stats"))
    return out


def flax_generator_variables(state_dict: Mapping[str, torch.Tensor],
                             model: str = "calciumgan") -> dict:
    """Inverse of :func:`generator_state_dict`: ``{"params": ...,
    "batch_stats": ...}``."""
    _check_model(model)
    if model == "mlp":
        return {"params": _flax_mlp_params(state_dict), "batch_stats": {}}
    params: dict = {}
    stats: dict = {}
    for name, tensor in state_dict.items():
        a = tensor.detach().cpu().float().numpy()
        module, field = name.rsplit(".", 1)
        parts = module.split(".")
        if (m := _DENSE_MODULE.match(module)) and field in _PARAM_FIELDS:
            group = params.setdefault(f"Dense_{m[1]}", {})
            group[{"weight": "kernel"}.get(field, field)] = (
                np.ascontiguousarray(a.T) if field == "weight" else a)
        elif parts[0] == "conv_transpose" and len(parts) == 2 \
                and field in _PARAM_FIELDS:
            group = params.setdefault(f"ConvTranspose_{parts[1]}", {})
            if field == "weight":
                group["kernel"] = _flax_conv_transpose_kernel(a)
            else:
                group[field] = a
        elif parts[0] == "norm" and len(parts) == 2 and field in _NORM_FIELDS:
            params.setdefault(f"Norm_{parts[1]}", {}).setdefault(
                "LayerNorm_0", {})[field] = a
        elif parts[0] == "norm" and parts[2:] == ["batch_norm"]:
            if field in _NORM_FIELDS:
                collection = params
            elif field in _STAT_FIELDS:
                collection = stats
            else:
                raise KeyError(f"unexpected state_dict entry {name!r}")
            collection.setdefault(f"Norm_{parts[1]}", {}).setdefault(
                "BatchNorm_0", {})[field] = a
        else:
            raise KeyError(f"unexpected state_dict entry {name!r}")
    return {"params": params, "batch_stats": stats}


def flax_generator_params(state_dict: Mapping[str, torch.Tensor],
                          model: str = "calciumgan") -> dict:
    """The ``params`` of :func:`flax_generator_variables`, for a generator
    without BatchNorm (one with it raises: its running statistics would be
    lost)."""
    variables = flax_generator_variables(state_dict, model)
    if variables["batch_stats"]:
        raise KeyError("the generator has BatchNorm running statistics: "
                       "take flax_generator_variables")
    return variables["params"]


def discriminator_state_dict(params: Mapping, model: str = "calciumgan"
                             ) -> Dict[str, torch.Tensor]:
    """Flax discriminator params of a ``model`` net -> ``state_dict``."""
    _check_model(model)
    if model == "mlp":
        return _mlp_state_dict(params)
    out = {}
    for key, sub in params.items():
        if m := _CONV.match(key):
            out[f"conv.{m[1]}.weight"] = _tensor(_conv_weight(sub["kernel"]))
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
    _check_model(model)
    if model == "mlp":
        return _flax_mlp_params(state_dict)
    params: dict = {}
    for name, tensor in state_dict.items():
        a = tensor.detach().cpu().float().numpy()
        module, field = _split(name, _PARAM_FIELDS)
        parts = module.split(".")
        if parts[0] == "conv" and len(parts) == 2:
            group = f"Conv_{parts[1]}"
            if field == "weight":
                a = _flax_conv_kernel(a)
        elif module == "dense":
            group = "Dense_0"
            if field == "weight":
                a = np.ascontiguousarray(a.T)
        else:
            raise KeyError(f"unexpected state_dict entry {name!r}")
        params.setdefault(group, {})[
            {"weight": "kernel"}.get(field, field)] = a
    return params
