"""Typed configuration of the port: a copy of the JAX package's ``Config``
(``calciumgan_tpu/config.py``), kept here so that the port imports nothing
of that package.

The fields, their defaults and the ``hparams.json`` contract are the JAX
package's, so either package reads the other's run directories, plus the
port's own :data:`PORT_FIELDS` (the JAX package reads them as extras, and
the port gives a JAX run's file their defaults):

- ``save()`` persists the full superset to ``<output_dir>/hparams.json``
  (atomically); in a data-parallel run rank 0 writes it, after every rank
  has filled it in.
- ``load()`` fills only *unset* fields, so flags typed on a CLI win.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

# Fields that are tuples on the python side but lists in JSON.
_TUPLE_FIELDS = ("signal_shape", "spike_shape", "noise_shape")
# Fields of the port alone, after the JAX package's.
PORT_FIELDS = ("adam_beta1", "adam_beta2")


@dataclass
class Config:
    """Full configuration: CLI flags + derived dataset/runtime attributes."""

    # --- CLI flags (the reference's main.py) ---
    input_dir: str = "dataset/tfrecords"
    output_dir: str = "runs"
    batch_size: int = 64
    num_units: int = 32
    kernel_size: int = 24
    strides: int = 2
    m: int = 2  # phase shuffle temporal shift
    n: int = 2  # phase shuffle neuron shift (2d model)
    epochs: int = 20
    dropout: float = 0.2
    learning_rate: float = 1e-4
    noise_dim: int = 32
    gradient_penalty: float = 10.0
    model: str = "calciumgan"
    activation: str = "leakyrelu"
    batch_norm: bool = False
    layer_norm: bool = False
    algorithm: str = "wgan-gp"
    n_critic: int = 5
    unroll_critic: bool = False  # JAX package only (XLA cost accounting)
    # generator-EMA decay per generator update (0 = off)
    ema: float = 0.0
    clear_output_dir: bool = False
    save_generated: str = ""  # "", "last", "all"
    plot_weights: bool = False
    skip_checkpoints: bool = False
    mixed_precision: bool = False
    profile: bool = False
    dpi: int = 120
    verbose: int = 1

    # --- additions of the JAX package (kept for hparams.json parity) ---
    seed: int = 1234
    data_parallelism: int = -1
    model_parallelism: int = 1
    time_parallelism: int = 1
    dcn_slices: int = 1
    checkpoint_every: int = 10
    device_store: str = "auto"
    device_store_mb: int = 4096

    # --- additions of the port (PORT_FIELDS) ---
    # Adam's betas: optax's defaults; WaveGAN's recipe trains at 0.5, 0.9
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999

    # --- runtime state ---
    global_step: int = 0
    start_epoch: int = 0
    surrogate_ds: bool = False

    # --- evaluation CLI flags ---
    num_processors: int = 6
    all_epochs: bool = False
    num_neuron_plots: int = 6
    num_trial_plots: int = 6
    plots_per_row: int = 3
    format: str = "pdf"
    num_samples: Optional[int] = None
    neurons: Optional[List[int]] = None
    trials: Optional[List[int]] = None
    num_trials: int = 5
    save_plots: bool = False

    # --- derived dataset attributes ---
    train_size: Optional[int] = None
    validation_size: Optional[int] = None
    signal_shape: Optional[Tuple[int, ...]] = None
    spike_shape: Optional[Tuple[int, ...]] = None
    sequence_length: Optional[int] = None
    num_neurons: Optional[int] = None
    num_channels: Optional[int] = None
    num_train_shards: Optional[int] = None
    num_validation_shards: Optional[int] = None
    buffer_size: Optional[int] = None
    normalize: bool = False
    fft: bool = False
    conv2d: bool = False
    # fft min-max statistics: "global" or "per_channel"
    fft_norm: str = "global"
    # scalars under global norm; (signal_shape)-shaped float32 arrays under
    # per-channel fft norm (nested lists in hparams.json, arrays after load)
    signals_min: Optional[Any] = None
    signals_max: Optional[Any] = None
    noise_shape: Optional[Tuple[int, ...]] = None
    train_steps: Optional[int] = None
    validation_steps: Optional[int] = None
    train_files: Optional[str] = None
    validation_files: Optional[str] = None

    # --- paths and bookkeeping ---
    focus_neurons: List[int] = field(
        default_factory=lambda: [87, 58, 90, 39, 7, 60, 14, 5, 13])
    generated_dir: Optional[str] = None
    validation_cache: Optional[str] = None
    ckpt_dir: Optional[str] = None
    git_hash: Optional[str] = None

    # Extra keys from loaded hparams.json that are not dataclass fields.
    extras: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        for name in _TUPLE_FIELDS:
            v = getattr(self, name)
            if isinstance(v, list):
                setattr(self, name, tuple(v))
        # Field names typed on a CLI (see from_args); load() never clobbers
        # them. Not a dataclass field, so it stays out of hparams.json.
        self._explicit: set = set()

    @classmethod
    def from_args(cls, args: Any) -> "Config":
        """Build a Config from an argparse Namespace (unknown keys go to
        ``extras``); every key of ``args`` counts as typed on the CLI."""
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs, extras = {}, {}
        for key, value in vars(args).items():
            if key in names:
                kwargs[key] = value
            else:
                extras[key] = value
        cfg = cls(**kwargs)
        cfg.extras.update(extras)
        cfg._explicit = set(vars(args).keys())
        return cfg

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        extras = d.pop("extras", {})
        d.update(extras)
        return d

    def save(self, path: Optional[str] = None) -> None:
        """Persist to ``<output_dir>/hparams.json`` (superset contract),
        atomically, so a reader never sees a torn file; rank 0 is the one
        writer (``config.py:199-209``)."""
        from calciumgan_tpu_torch.parallel import mesh as mesh_lib
        if self.git_hash is None:
            self.git_hash = _git_hash()
        if mesh_lib.process_index() != 0:
            return
        path = path or os.path.join(self.output_dir, "hparams.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=_json_default)
        os.replace(tmp, path)

    def load(self, path: Optional[str] = None) -> "Config":
        """Fill *unset* fields from a saved hparams.json: a field typed on
        the CLI (``_explicit``) is never overwritten; any other is filled
        while it is None or still holds its dataclass default."""
        path = path or os.path.join(self.output_dir, "hparams.json")
        with open(path) as f:
            content = json.load(f)
        defaults = {f.name: f.default for f in dataclasses.fields(type(self))
                    if f.default is not dataclasses.MISSING}
        names = {f.name for f in dataclasses.fields(type(self))}
        explicit = getattr(self, "_explicit", set())
        for key, value in content.items():
            if key == "extras":
                continue
            if key not in names:
                self.extras[key] = value
                continue
            if key in explicit:
                continue
            current = getattr(self, key)
            is_default = key in defaults and _safe_eq(current, defaults[key])
            if current is None or is_default:
                if key in _TUPLE_FIELDS and isinstance(value, list):
                    value = tuple(value)
                if (key in ("signals_min", "signals_max")
                        and isinstance(value, list)):
                    # per-channel fft norm: JSON nested lists -> arrays
                    import numpy as np
                    value = np.asarray(value, np.float32)
                setattr(self, key, value)
        return self

    @property
    def dtype_name(self) -> str:
        return "bfloat16" if self.mixed_precision else "float32"

    def validate_model_shapes(self) -> None:
        """The reference asserts ``sequence_length % strides**5 == 0``."""
        if self.sequence_length is None:
            raise ValueError("sequence_length is unset; load a dataset first")
        if self.model in ("calciumgan", "calciumgan2d"):
            w = self.sequence_length / (self.strides ** 5)
            if not float(w).is_integer():
                raise ValueError(
                    f"sequence_length {self.sequence_length} is not divisible "
                    f"by strides**5 ({self.strides ** 5}): w={w}")


def _safe_eq(a, b) -> bool:
    """Scalar equality that never raises on array-valued fields."""
    try:
        return bool(a == b)
    except (ValueError, TypeError):
        return False


def _git_hash() -> str:
    try:
        return subprocess.check_output(
            ["git", "describe", "--always"],
            stderr=subprocess.DEVNULL).strip().decode()
    except Exception:
        return "unknown"


def _json_default(obj):
    """Coerce numpy scalars and arrays (and anything else) for json.dump."""
    try:
        import numpy as np
        if isinstance(obj, np.generic):
            return obj.item()
        if isinstance(obj, np.ndarray):
            return obj.tolist()
    except ImportError:
        pass
    return str(obj)
