"""Array-layout utilities: a copy of ``calciumgan_tpu/utils/arrays.py``.

The reference tags array layouts implicitly by matching dims against
``sequence_length`` / ``num_neurons`` to produce an NWC-style format string
(reference ``gan/utils/utils.py:155-184``). That relies on
``sequence_length != num_neurons``, which is checked explicitly here.
"""

from __future__ import annotations

import numpy as np


def get_array_format(shape, config) -> str:
    """Infer 'N'/'W'/'C' per dim: W == sequence_length, C == num_neurons.

    The inference is only well-defined when the two differ: otherwise every
    matching dim would be tagged 'W' and transposes would silently be wrong.
    """
    assert len(shape) <= 3
    if config.sequence_length == config.num_neurons:
        raise ValueError(
            "array-format inference is ambiguous: sequence_length == "
            f"num_neurons == {config.sequence_length}")
    fmt = "".join(
        "W" if s == config.sequence_length else
        "C" if s == config.num_neurons else "N" for s in shape)
    # a batch dim that collides with W or C would duplicate the tag and
    # silently transpose wrongly (current.index picks the first match)
    if fmt.count("W") > 1 or fmt.count("C") > 1:
        raise ValueError(
            f"array-format inference is ambiguous for shape {tuple(shape)}: "
            f"inferred {fmt!r} (a batch dim equals sequence_length or "
            "num_neurons)")
    return fmt


def set_array_format(array: np.ndarray, data_format: str,
                     config) -> np.ndarray:
    """Transpose ``array`` into ``data_format`` (e.g. 'NWC' -> 'CNW')."""
    assert array.ndim == len(data_format)
    current = get_array_format(array.shape, config)
    assert set(current) == set(data_format), \
        f"cannot convert {current} to {data_format}"
    if current == data_format:
        return array
    perm = [current.index(s) for s in data_format]
    return np.transpose(array, axes=perm)


def swap_neuron_major(config, array: np.ndarray) -> np.ndarray:
    """(validation_size, num_neurons, ...) <-> neuron-major."""
    shape = (config.validation_size, config.num_neurons)
    return np.swapaxes(array, 0, 1) if array.shape[:2] == shape else array


def remove_nan(array: np.ndarray) -> np.ndarray:
    return array[np.logical_not(np.isnan(array))]
