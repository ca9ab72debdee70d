"""The port imports nothing of the JAX package, and its copies of the JAX
package's modules equal the originals.

Every ``.py`` file of ``calciumgan_tpu_torch/`` (the parallel package
``parallel/`` included, its model and time axes too) and ``chip_smoke.py`` is walked as an AST
(imports inside functions included) for imports of ``calciumgan_tpu``,
``jax``, ``flax`` or ``optax`` and for paths into ``calciumgan_tpu/``.
The copies (``Config``, ``Registry``, ``ifft_signals``, the float64 golden
and ``synth_ar1_traces``, the h5 functions, the array layouts,
``segments``, ``io``'s info file, the figure renderers, the C++ float64
redo and crc32c, the TFRecord codec, the event writer, the signal metrics
and the phase shuffle, the DG model's host helpers and the DG metrics'
percentage errors) are held against the JAX package's modules on seeded
inputs. ``--model_parallelism`` reaches the layout.
"""

import argparse
import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import compute_dg_metrics as root_dg_metrics
from calciumgan_tpu import config as jax_config
from calciumgan_tpu import native
from calciumgan_tpu import registry as jax_registry
from calciumgan_tpu.data import segments
from calciumgan_tpu.data import tfrecord as jax_tfrecord
from calciumgan_tpu.ops import dg as jax_dg
from calciumgan_tpu.ops import oasis_ref
from calciumgan_tpu.ops import phase_shuffle as jax_shuffle
from calciumgan_tpu.ops import signal_metrics as jax_metrics
from calciumgan_tpu.utils import arrays as jax_arrays
from calciumgan_tpu.utils import h5 as jax_h5
from calciumgan_tpu.utils import io as jax_io
from calciumgan_tpu.utils import plots as jax_plots
from calciumgan_tpu.utils import tb as jax_tb
from calciumgan_tpu.utils.tb_reader import read_scalars
from calciumgan_tpu_torch import compute_dg_metrics as port_dg_metrics
from calciumgan_tpu_torch import config as port_config
from calciumgan_tpu_torch.data import pipeline as port_pipeline
from calciumgan_tpu_torch.data import tfrecord as port_tfrecord
from calciumgan_tpu_torch.models import registry as port_registry
from calciumgan_tpu_torch.ops import dg as port_dg
from calciumgan_tpu_torch.ops import golden
from calciumgan_tpu_torch.ops import oasis as port_oasis
from calciumgan_tpu_torch.ops import phase_shuffle as port_shuffle
from calciumgan_tpu_torch.ops import signal_metrics as port_metrics
from calciumgan_tpu_torch.data import segments as port_segments
from calciumgan_tpu_torch.utils import arrays as port_arrays
from calciumgan_tpu_torch.utils import h5 as port_h5
from calciumgan_tpu_torch.utils import io as port_io
from calciumgan_tpu_torch.utils import plots as port_plots
from calciumgan_tpu_torch.utils import tb as port_tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "calciumgan_tpu_torch")
FORBIDDEN = {"calciumgan_tpu", "jax", "flax", "optax"}
# a citation "calciumgan_tpu/<file>.py:<line>" names the TPU kernel a
# port kernel replaces (chip_smoke.py's `replaces`); it opens nothing
_CITATION = re.compile(r"^calciumgan_tpu/[\w/]+\.py:\d+$")


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


def _docstrings(tree):
    nodes = [tree] + [n for n in ast.walk(tree) if isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    return {id(n.body[0].value) for n in nodes
            if n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


def _violations(source: str) -> list:
    tree = ast.parse(source)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names
                      if a.name.split(".")[0] in FORBIDDEN]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and (
                    node.module.split(".")[0] in FORBIDDEN):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(
                func, "id", "")
            if name in ("import_module", "__import__") and (
                    node.args[0].value.split(".")[0] in FORBIDDEN):
                found.append(node.args[0].value)
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            parts = re.split(r"[/\\]", node.value)
            if "calciumgan_tpu" in parts and not _CITATION.match(node.value):
                found.append(f"path {node.value!r}")
    return found


@pytest.mark.parametrize("path", _sources())
def test_port_file_imports_nothing_of_the_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        assert _violations(f.read()) == [], path


@pytest.mark.parametrize("source", [
    "import calciumgan_tpu.ops.oasis_ref\n",
    "def f():\n    from calciumgan_tpu import native\n",
    "def f():\n    import jax.numpy as jnp\n",
    "from flax import linen\n",
    "import importlib\nimportlib.import_module('optax')\n",
    "p = os.path.join(root, 'calciumgan_tpu', 'native', 'x.cc')\n",
    "p = Path(root) / 'calciumgan_tpu/native/calciumgan_native.cc'\n",
])
def test_boundary_check_catches(source):
    # the walk above finds each way in, even inside a function
    assert _violations(source)


def test_port_loads_no_jax_package_module():
    code = (
        "import sys\n"
        "import calciumgan_tpu_torch.config, calciumgan_tpu_torch.generate\n"
        "import calciumgan_tpu_torch.ops.oasis\n"
        "import calciumgan_tpu_torch.dataset.spike_train_inference\n"
        "import calciumgan_tpu_torch.main, calciumgan_tpu_torch.train\n"
        "import calciumgan_tpu_torch.compute_metrics\n"
        "import calciumgan_tpu_torch.dataset.generate_tfrecords\n"
        "import calciumgan_tpu_torch.eval.spike_eval\n"
        "import calciumgan_tpu_torch.ops.spike_metrics\n"
        "import calciumgan_tpu_torch.utils.io, calciumgan_tpu_torch.utils.h5\n"
        "import calciumgan_tpu_torch.utils.arrays\n"
        "import calciumgan_tpu_torch.utils.plots\n"
        "import calciumgan_tpu_torch.data.segments\n"
        "import calciumgan_tpu_torch.ops.dg, calciumgan_tpu_torch.models.mlp\n"
        "import calciumgan_tpu_torch.compute_dg_metrics\n"
        "import calciumgan_tpu_torch.dataset.generate_dg_data\n"
        "import calciumgan_tpu_torch.dataset.generate_surrogate_data\n"
        "import calciumgan_tpu_torch.dataset.get_coordinate\n"
        "import calciumgan_tpu_torch.parallel.launch\n"
        "import calciumgan_tpu_torch.parallel.mesh\n"
        "import calciumgan_tpu_torch.parallel.halo_conv\n"
        "import calciumgan_tpu_torch.parallel.seq_parallel\n"
        "import calciumgan_tpu_torch.parallel.long_context\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('calciumgan_tpu', 'jax', 'jaxlib', 'flax', 'optax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_walk_covers_the_parallel_package():
    walked = _sources()
    for name in ("__init__.py", "launch.py", "mesh.py", "halo_conv.py",
                 "seq_parallel.py", "long_context.py"):
        assert os.path.join("calciumgan_tpu_torch", "parallel",
                            name) in walked


def test_model_parallelism_flag_reaches_the_layout(tmp_path):
    # the CLI's --model_parallelism lays out a model axis (it was once
    # ignored, then refused); one device cannot hold two model ranks
    from calciumgan_tpu_torch import main as port_main
    from calciumgan_tpu_torch import train as port_train
    config, device = port_main.parse_args([
        "--model_parallelism", "2", "--device", "cpu",
        "--input_dir", str(tmp_path), "--output_dir", str(tmp_path / "run")])
    layout = port_train.layout(config, ["cpu"] * 2)
    assert (layout.data_parallelism, layout.model_parallelism) == (1, 2)
    with pytest.raises(ValueError, match="1 devices/slice not divisible by "
                                         "model_parallelism 2"):
        port_train.main(config, device=device)


# ---- Config ---------------------------------------------------------------

def _field_table(cls):
    return [(f.name, str(f.type), f.default if f.default_factory is
             dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)]


def _jax_fields(table):
    """The rows of the JAX package's fields: the port's own fields
    (``PORT_FIELDS``) left out."""
    return [row for row in table if row[0] not in port_config.PORT_FIELDS]


def _port_defaults(cls=port_config.Config):
    return {f.name: f.default for f in dataclasses.fields(cls)
            if f.name in port_config.PORT_FIELDS}


def test_config_fields_and_defaults_equal_jax():
    port = _field_table(port_config.Config)
    assert _jax_fields(port) == _field_table(jax_config.Config)
    assert [row[0] for row in port if row[0] in port_config.PORT_FIELDS] \
        == list(port_config.PORT_FIELDS)
    assert _port_defaults() == {"adam_beta1": 0.9, "adam_beta2": 0.999}
    assert port_config._TUPLE_FIELDS == jax_config._TUPLE_FIELDS


def _sample(cls):
    return cls(model="calciumgan", sequence_length=2048, num_neurons=102,
               num_channels=102, signal_shape=[2048, 102], noise_dim=32,
               layer_norm=True, signals_min=0.0, signals_max=1.5, ema=0.99,
               seed=7, git_hash="abc123")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_hparams_round_trip(tmp_path, writer):
    # either package reads the hparams.json the other writes
    mods = {"port": port_config.Config, "jax": jax_config.Config}
    reader = mods["jax" if writer == "port" else "port"]
    saved = _sample(mods[writer])
    saved.extras["legacy_flag"] = 3
    run = str(tmp_path / "run")
    saved.save(os.path.join(run, "hparams.json"))
    loaded = reader(output_dir=run).load()
    # the port's own fields: JAX keeps a port file's as extras, the port
    # gives a JAX file's their defaults
    own = _port_defaults()
    expected = saved.to_dict() | {"output_dir": run}
    if writer == "jax":
        expected |= own
    assert loaded.to_dict() == expected
    assert loaded.signal_shape == (2048, 102)
    assert loaded.extras == {"legacy_flag": 3} | (
        own if writer == "port" else {})
    with open(os.path.join(run, "hparams.json")) as f:
        assert json.load(f)["ema"] == 0.99


def test_config_load_keeps_cli_flags_as_jax_does(tmp_path):
    _sample(jax_config.Config).save(str(tmp_path / "hparams.json"))
    args = argparse.Namespace(output_dir=str(tmp_path), seed=1234,
                              num_samples=10)
    ours = port_config.Config.from_args(args).load()
    theirs = jax_config.Config.from_args(args).load()
    assert ours.to_dict() == theirs.to_dict() | _port_defaults()
    assert ours.seed == 1234 and ours.ema == 0.99


@pytest.mark.parametrize("sl,ok", [(2048, True), (48, False)])
def test_config_validate_model_shapes_equal_jax(sl, ok):
    for cls in (port_config.Config, jax_config.Config):
        cfg = cls(sequence_length=sl)
        if ok:
            cfg.validate_model_shapes()
        else:
            with pytest.raises(ValueError, match="strides"):
                cfg.validate_model_shapes()


# ---- Registry, ifft_signals, h5 --------------------------------------------

def test_registry_behaves_as_jax():
    for cls in (port_registry.Registry, jax_registry.Registry):
        reg = cls("model")
        reg.register("a")(1)
        assert reg.get("a") == 1 and "a" in reg and reg.names() == ["a"]
        with pytest.raises(KeyError, match="duplicate model"):
            reg.register("a")(2)
        with pytest.raises(KeyError, match="unknown model 'b'"):
            reg.get("b")


@pytest.mark.parametrize("shape", [(3, 64, 8), (2, 33, 10)])
def test_ifft_signals_equals_jax(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ours = port_pipeline.ifft_signals(x)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, segments.ifft_signals(x))


def test_h5_write_appends_as_jax_reads(tmp_path):
    rng = np.random.default_rng(4)
    parts = [rng.standard_normal((n, 16, 3)).astype(np.float32)
             for n in (2, 5)]
    out = str(tmp_path / "samples.h5")
    for part in parts:
        port_h5.write(out, {"signals": part,
                            "spikes": (part > 0).astype(np.int8)})
    full = np.concatenate(parts)
    np.testing.assert_array_equal(jax_h5.get(out, "signals"), full)
    np.testing.assert_array_equal(jax_h5.get(out, "spikes"),
                                  (full > 0).astype(np.int8))


# ---- float64 golden and the C++ redo ----------------------------------------

@pytest.mark.parametrize("n,T,rate", [(4, 300, 0.02), (3, 500, 0.2)])
def test_synth_traces_equal_jax(n, T, rate):
    ours = golden.synth_ar1_traces(np.random.default_rng(5), n, T, rate=rate)
    theirs = oasis_ref.synth_ar1_traces(np.random.default_rng(5), n, T,
                                        rate=rate)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("lam,s_min", [(0.0, 0.55), (0.0, 0.0), (1.0, 0.2)])
def test_golden_oasis_equals_jax(lam, s_min):
    y = golden.synth_ar1_traces(np.random.default_rng(6), 3, 400)
    for row in y:
        ours = golden.oasis_ar1(row, g=0.95, lam=lam, s_min=s_min)
        theirs = oasis_ref.oasis_ar1(row, g=0.95, lam=lam, s_min=s_min)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        golden.deconvolve_signals_ref(y, s_min=s_min),
        oasis_ref.deconvolve_signals_ref(y, s_min=s_min))


@pytest.mark.parametrize("T", [200, 4500])
def test_cxx_redo_copy_equals_jax_golden(T):
    y = golden.synth_ar1_traces(np.random.default_rng(8), 5, T)
    built = port_oasis.host_library()
    assert os.path.basename(built.path).startswith("liboasis_host-")
    spikes = port_oasis._exact_spikes_host(y, 0.95, 0.55, 0.5)
    np.testing.assert_array_equal(spikes, oasis_ref.deconvolve_signals_ref(
        y.astype(np.float64)).astype(np.int8))


def test_cxx_redo_source_lives_in_the_port():
    # a file of csrc/ (the kernel build hashes every entry of it)
    assert os.path.isfile(os.path.join(PORT, "csrc", "oasis_host.cc"))


# ---- the training slice's copies --------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 835_587])
def test_crc32c_copy_equals_jax_native(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert port_tfrecord.crc32c(data) == native.crc32c(data)
    assert port_tfrecord.masked_crc32c(data) == jax_tfrecord.masked_crc32c(
        data)
    built = port_tfrecord.crc_library()
    assert os.path.basename(built.path).startswith("libcrc32c-")
    assert os.path.isfile(os.path.join(PORT, "csrc", "crc32c.cc"))


def test_example_codec_equals_jax():
    feats = {"signal": b"\x00\x01" * 300, "spike": b"", "x": b"\xff" * 200}
    encoded = port_tfrecord.encode_example(feats)
    assert encoded == jax_tfrecord.encode_example(feats)
    assert port_tfrecord.decode_example(encoded) == \
        jax_tfrecord.decode_example(encoded)


def test_event_writer_equals_jax(tmp_path):
    values = np.random.default_rng(2).standard_normal(500)
    assert port_tb.histogram_proto(values) == jax_tb.histogram_proto(values)
    assert port_tb._event(b"abc", 7, 1.5) == jax_tb._event(b"abc", 7, 1.5)
    writer = port_tb.EventWriter(str(tmp_path))
    writer.scalar("loss/x", 0.25, step=3)
    writer.histogram("w", values, step=3)
    writer.image("fig/image/0", b"\x89PNG", height=2, width=3, step=3)
    writer.close()
    assert read_scalars(str(tmp_path)) == {"loss/x": {3: 0.25}}


@pytest.mark.parametrize("masked", [False, True])
def test_signal_metrics_copy_equals_jax(masked):
    rng = np.random.default_rng(9)
    real, fake = (rng.random((4, 16, 5)).astype(np.float32)
                  for _ in range(2))
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    ours = port_metrics.all_signal_metrics(
        torch.from_numpy(real), torch.from_numpy(fake),
        None if mask is None else torch.from_numpy(mask))
    theirs = jax_metrics.all_signal_metrics(
        jnp.asarray(real), jnp.asarray(fake),
        None if mask is None else jnp.asarray(mask))
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(float(ours[k]), float(theirs[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("m", [1, 4])
def test_phase_shuffle_copy_equals_jax(m):
    x = np.random.default_rng(m).standard_normal((2, 6, 3)).astype(
        np.float32)
    for shift in range(-m, m + 1):
        np.testing.assert_array_equal(
            port_shuffle.phase_shuffle(torch.from_numpy(x), shift, m,
                                       axis=1).numpy(),
            np.asarray(jax_shuffle._shift_axis(jnp.asarray(x),
                                               jnp.asarray(shift), m, 1)))


# ---- the evaluation and dataset-preparation slice's copies ------------------

def _public(module):
    return sorted(n for n, v in vars(module).items()
                  if callable(v) and not n.startswith("_")
                  and getattr(v, "__module__", None) == module.__name__)


def test_h5_copy_has_every_function_of_the_original(tmp_path):
    assert set(_public(jax_h5)) <= set(_public(port_h5))
    out = str(tmp_path / "x.h5")
    value = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    for module in (port_h5, jax_h5):
        module.write(out, {"a": value[:2]})
        module.write(out, {"a": value[2:]})
        module.truncate(out, "a", 3)
        module.rename(out, "a", "b")  # the second replaces the first's
    for module in (port_h5, jax_h5):
        assert module.keys(out) == ["b"] and module.get_shape(
            out, "b") == (3, 3, 2)
        np.testing.assert_array_equal(module.get(out, "b", start=1),
                                      value[1:3])


def test_arrays_copy_equals_the_original():
    assert _public(port_arrays) == _public(jax_arrays)
    cfg = port_config.Config(sequence_length=16, num_neurons=3,
                             validation_size=5)
    x = np.random.default_rng(1).random((5, 3, 16))
    for fmt in ("NWC", "WNC"):
        np.testing.assert_array_equal(
            port_arrays.set_array_format(x, fmt, cfg),
            jax_arrays.set_array_format(x, fmt, cfg))
    assert port_arrays.get_array_format(x.shape, cfg) == "NCW"


@pytest.mark.parametrize("kw", [
    dict(do_normalize=True),
    dict(apply_fft=True, do_normalize=True, fft_norm="per_channel"),
    dict(conv2d=True, is_dg_data=True)])
def test_segments_copy_equals_the_original(kw):
    assert set(_public(segments)) - {"ifft_signals"} <= set(
        _public(port_segments))
    assert port_segments.ifft_signals is port_pipeline.ifft_signals
    rng = np.random.default_rng(2)
    data = {"signals": rng.standard_normal((7, 300)).astype(np.float32),
            "oasis": (rng.random((7, 300)) < 0.1).astype(np.float32)}
    ours = port_segments.preprocess(data, 32, 5, **kw)
    theirs = segments.preprocess(data, 32, 5, **kw)
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_array_equal(a, b)
    assert list(ours[2]) == list(theirs[2])
    for key, value in ours[2].items():
        np.testing.assert_array_equal(value, theirs[2][key])


def test_io_info_file_equals_the_original(tmp_path):
    rng = np.random.default_rng(3)
    batch = rng.random((3, 16, 4)).astype(np.float32)
    infos = []
    for mod, cls, name in ((port_io, port_config.Config, "ours"),
                           (jax_io, jax_config.Config, "theirs")):
        cfg = cls(output_dir=str(tmp_path / name), global_step=11,
                  verbose=0)
        cfg.generated_dir = os.path.join(cfg.output_dir, "generated")
        os.makedirs(cfg.generated_dir)
        mod.save_fake_signals(cfg, 7, batch, append=False)
        mod.save_fake_signals(cfg, 7, batch)
        infos.append(mod.load_generated_info(cfg))
        assert jax_h5.get_shape(infos[-1][7]["filename"],
                                "signals") == (6, 16, 4)
    assert list(infos[0]) == list(infos[1]) == [7]
    assert infos[0][7]["global_step"] == infos[1][7]["global_step"] == 11
    assert [os.path.basename(i[7]["filename"]) for i in infos] == [
        "epoch007_signals.h5"] * 2


def test_plot_renderers_copy_equals_the_original():
    assert sorted(port_plots.RENDERERS) == sorted(jax_plots.RENDERERS)
    assert (port_plots.REAL_COLOR, port_plots.FAKE_COLOR,
            port_plots.FRAMERATE) == (jax_plots.REAL_COLOR,
                                      jax_plots.FAKE_COLOR,
                                      jax_plots.FRAMERATE)
    rng = np.random.default_rng(4)
    payload = dict(data=[(rng.random(20), rng.random(30))] * 2,
                   xlabel="Hz", ylabel="Count", titles=["a", "b"],
                   legend_labels=["recorded", "synthetic"], plots_per_row=2)
    ours = port_plots.render_and_save("histograms_grid", payload,
                                      {"dpi": 50})
    theirs = jax_plots.render_and_save("histograms_grid", payload,
                                       {"dpi": 50})
    assert ours[1:] == theirs[1:] and ours[0][:8] == b"\x89PNG\r\n\x1a\n"


# ---- the DG slice's copies ---------------------------------------------------

def _near_correlation(rng, n, defect):
    a = rng.normal(size=(n, n))
    m = (a + a.T) / 2
    np.fill_diagonal(m, 1.0)
    m[0, 1] = m[1, 0] = defect
    return m


@pytest.mark.parametrize("n,defect", [(6, 5.0), (4, 0.2), (9, -3.0)])
def test_higham_copy_equals_the_original(n, defect):
    m = _near_correlation(np.random.default_rng(n), n, defect)
    for kw in ({}, {"maxiters": 3}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ours = port_dg.Higham(**kw).higham_correction(m)
            theirs = jax_dg.Higham(**kw).higham_correction(m)
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(port_dg.Higham.projection_S(m),
                                  jax_dg.Higham.projection_S(m))
    np.testing.assert_array_equal(port_dg.Higham.projection_U(m),
                                  jax_dg.Higham.projection_U(m))
    with pytest.warns(port_dg.WarningDG, match="iteration cap"):
        port_dg.Higham(maxiters=3).higham_correction(
            _near_correlation(np.random.default_rng(6), 6, 5.0))
    assert issubclass(port_dg.WarningDG, UserWarning)


def test_dg_matrix_helpers_equal_the_originals():
    rng = np.random.default_rng(12)
    a = rng.normal(size=(5, 5))
    cov = a @ a.T
    np.testing.assert_array_equal(port_dg.cov_to_corr(cov),
                                  jax_dg.cov_to_corr(cov))
    lopsided = cov + np.triu(rng.normal(size=(5, 5)), 1)
    np.testing.assert_array_equal(port_dg.make_symmetric(lopsided),
                                  jax_dg.make_symmetric(lopsided))
    assert port_dg.make_symmetric(cov) is cov  # symmetric: returned as is
    for m in (cov, _near_correlation(rng, 5, 5.0), np.zeros((3, 3))):
        assert port_dg.is_positive_definite(m) == \
            jax_dg.is_positive_definite(m)
    assert port_dg.is_positive_definite(cov)
    assert not port_dg.is_positive_definite(np.zeros((3, 3)))
    assert (port_dg._GL_ORDER, list(port_dg._GL_NODES)) == (
        jax_dg._GL_ORDER, list(jax_dg._GL_NODES))


def test_percentage_error_copies_equal_the_originals():
    rng = np.random.default_rng(13)
    y_true = rng.random((30, 5))
    y_true[rng.random((30, 5)) < 0.2] = 0.0  # the zero-target rule
    y_pred = rng.random((30, 5))
    for i in range(5):
        np.testing.assert_array_equal(
            port_dg_metrics.percentage_error(y_true[:, i], y_pred[:, i]),
            root_dg_metrics.percentage_error(y_true[:, i], y_pred[:, i]))
    assert port_dg_metrics.mean_absolute_percentage_error(y_true, y_pred) \
        == root_dg_metrics.mean_absolute_percentage_error(y_true, y_pred)
