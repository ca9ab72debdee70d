"""Flax generator parameters <-> the port's ``state_dict``.

Flax names its submodules by class and order (``Dense_0``,
``ConvTranspose_0..4``, ``Norm_i/LayerNorm_0``, ``Dense_1``); the port's
:class:`~calciumgan_tpu_torch.models.calciumgan.Generator` names them
``dense_0``, ``conv_transpose.i``, ``norm.i``, ``dense_1``. Layouts:

- Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``;
- ConvTranspose kernel ``(K, Cin, Cout)`` -> ``(Cin, Cout, K)`` with the K
  axis flipped: Flax does not flip its kernel (``transpose_kernel=False``),
  ``F.conv_transpose1d`` does;
- LayerNorm ``scale``/``bias`` unchanged. A size-1 channel axis has no
  LayerNorm (``calciumgan_tpu/models/base.py:45-70``), so no entry.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = re.compile(r"Dense_(\d+)$")
_CONV_T = re.compile(r"ConvTranspose_(\d+)$")
_NORM = re.compile(r"Norm_(\d+)$")


def generator_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax generator params (nested dict of arrays) -> ``state_dict``."""
    out = {}

    def put(name, array):
        out[name] = torch.from_numpy(np.array(array, np.float32, order="C"))

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


def flax_generator_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`generator_state_dict`."""
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
