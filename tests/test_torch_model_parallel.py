"""The port's model axis (``calciumgan_tpu_torch.parallel.mesh``) against
the JAX package's ``parallel/mesh.py`` and its unsharded steps.

- ``create_mesh`` with a model axis gives the JAX function's layouts (the
  port's ranks in the order of the JAX mesh's devices, slices included)
  and errors on the same arguments;
- the parameters the port shards, and their specs, are those JAX's
  ``state_shardings`` shards on the same configurations: the tiny
  configuration's critic head alone (``tests/test_algorithms.py:216-224``,
  ``(40, 1)`` -> ``(20, 1)`` a rank, ``(1, 20)`` in the port's ``(out,
  in)`` layout), and at the default widths the generator's input
  projection and the critic's head of ``calciumgan`` and ``calciumgan2d``,
  the mlp critic's first layer and head;
- a 2-rank model-2 step of each case of ``CASES`` (the tiny
  configuration; one of 256 frames whose generator input projection is
  sharded too, with and without the EMA; the mlp critic, whose first
  layer is sharded by output columns, under ``wgan-gp`` and ``gan`` with
  dropout; calciumgan2d with its projection sharded; ``gan``;
  BatchNorm) and a 4-rank data-2 x model-2 step, replaying the JAX step's
  draws: the losses and the penalty within rtol 1e-4 of JAX's unsharded
  ``train_step``, as the JAX package's own model-parallel test holds its
  mesh to it, and the eval step's losses likewise
  (``tests/test_algorithms.py:226-245``); every rank's tensors (buffers
  and the EMA among them) equal bit for bit, the shards' gathered whole;
  the EMA gathered whole within 1e-6 of JAX's;
- ``main --model_parallelism 2 --plot_weights`` in 2 gloo ranks writes
  the checkpoint a one-process run writes (whole tensors), which a
  one-process run resumes and ``generate`` serves, and the parameter
  counts and weight statistics of a one-process run; 2 ranks resume a
  one-process checkpoint, each keeping its block.

All rank work runs in one launch of 2 gloo ranks and one of 4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu.algorithms import get_algorithm as jax_get_algorithm
from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.models import get_models as jax_get_models
from calciumgan_tpu.parallel import mesh as jax_mesh
from calciumgan_tpu.utils.tb_reader import read_scalars
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch import train as train_lib
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.parallel import launch as launch_lib
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import checkpoint, h5
import torch_rank_helpers as ranks
from test_torch_multiprocess import flags, records  # noqa: F401 (fixture)
from torch_step_helpers import make_pair, real_batch, recording, sizes_of, tiny

torch.set_num_threads(1)

TIMEOUT = 300
RTOL = 1e-4  # losses, penalty and eval losses vs JAX's unsharded step
EMA_ATOL = 1e-6  # the EMA gathered whole vs JAX's
LONG = dict(n_critic=1, sequence_length=256, signal_shape=(256, 6))
CASES = {"tiny": dict(n_critic=1),
         "long": LONG,
         "mlp": dict(model="mlp", n_critic=1),
         "mlp-gan": dict(model="mlp", algorithm="gan"),
         "2d": dict(model="calciumgan2d", n_critic=1, sequence_length=128,
                    signal_shape=(128, 6, 1)),
         "long-ema": dict(LONG, ema=0.999),
         "gan": dict(algorithm="gan"),
         "batch_norm": dict(n_critic=1, batch_norm=True)}
EVAL_MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
# rows of a BatchNorm pass on model peers (N, C, W)
BN_ROWS = np.random.default_rng(7).normal(
    1.0, 2.0, (8, 4, 16)).astype(np.float32)


# ---- layouts -------------------------------------------------------------

@pytest.mark.parametrize("dp,mp,slices,n", [
    (-1, 2, 1, 8), (4, 2, 1, 8), (2, 2, 2, 8), (1, 2, 1, 2), (-1, 4, 1, 8),
    (2, 2, 1, 8), (1, 2, 2, 8), (-1, 2, 2, 8)])
def test_create_mesh_with_a_model_axis_equals_jax(dp, mp, slices, n):
    theirs = jax_mesh.create_mesh(dp, mp, devices=jax.devices()[:n],
                                  slices=slices)
    ours = mesh_lib.create_mesh(dp, mp, [f"cuda:{i}" for i in range(n)],
                                slices=slices)
    assert [f"cuda:{d.id}" for d in theirs.devices.flat] == list(ours.devices)
    assert mesh_lib.data_extent(ours) == jax_mesh.data_extent(theirs)
    assert ours.model_parallelism == theirs.shape["model"]
    assert ours.shape["data"] * ours.shape["model"] == theirs.devices.size


@pytest.mark.parametrize("dp,mp,slices,n", [
    (-1, 3, 1, 8), (4, 4, 1, 8), (-1, 3, 2, 8), (2, 2, 2, 4), (3, 2, 1, 4)])
def test_create_mesh_with_a_model_axis_refuses_as_jax_does(dp, mp, slices,
                                                           n):
    with pytest.raises(ValueError) as theirs:
        jax_mesh.create_mesh(dp, mp, devices=jax.devices()[:n],
                             slices=slices)
    with pytest.raises(ValueError) as ours:
        mesh_lib.create_mesh(dp, mp, ["cpu"] * n, slices=slices)
    assert str(ours.value) == str(theirs.value)


# ---- parameter shardings ---------------------------------------------------

def _default(model):
    """A ``model`` run at the default widths (noise 32, units 32, kernel
    24) on its data's shape: 2048 x 102 (x 1 for conv2d), the surrogate
    set's 6 x 2 for the mlp."""
    base = dict(algorithm="wgan-gp", noise_dim=32, num_units=32,
                kernel_size=24, strides=2, m=2, batch_size=8, layer_norm=True,
                normalize=True, signals_min=0.0, signals_max=1.0)
    shapes = {"calciumgan": (2048, 102), "calciumgan2d": (2048, 102, 1),
              "mlp": (6, 2)}
    shape = shapes[model]
    return dict(base, model=model, sequence_length=shape[0],
                num_neurons=shape[1], num_channels=shape[-1],
                signal_shape=shape, dropout=0.2)


def _jax_sharded(sizes, model_parallelism):
    """``net/Flax path`` -> (spec, shape) of every parameter JAX's
    ``state_shardings`` does not replicate."""
    cfg = JaxConfig(**sizes)
    algo = jax_get_algorithm(cfg, *jax_get_models(cfg))
    state = jax.eval_shape(lambda: algo.init_state(jax.random.PRNGKey(0)))
    mesh = jax_mesh.create_mesh(8 // model_parallelism, model_parallelism)
    shardings = jax_mesh.state_shardings(mesh, state)
    out = {}
    for net in ("generator", "discriminator"):
        shapes = dict(jax.tree_util.tree_leaves_with_path(
            getattr(state, net).params))
        for path, s in jax.tree_util.tree_leaves_with_path(
                getattr(shardings, net).params):
            if s.spec != jax.sharding.PartitionSpec():
                out[f"{net}/" + "/".join(p.key for p in path)] = (
                    tuple(s.spec), shapes[path].shape)
    return out


def _port_sharded(sizes, model_parallelism):
    cfg = Config(**sizes)
    gen, dis = get_models(cfg, rng=torch.Generator().manual_seed(0))
    nets = {"generator": gen, "discriminator": dis}
    specs = mesh_lib.model_shardings(nets, cfg.model, model_parallelism)
    out = {}
    for key, spec in specs.items():
        if spec:
            kind, name = key.split("/", 1)
            path = convert.flax_param_path(kind, name, cfg.model)
            shape = tuple(dict(nets[kind].named_parameters())[name].shape)
            out[f"{kind}/" + "/".join(path)] = (spec, shape[::-1])
    return out


# written out: what model parallelism shards at the default widths
DEFAULT_SHARDED = {
    "calciumgan": {
        "generator/Dense_0/kernel": ((None, "model"), (32, 2048)),
        "discriminator/Dense_0/kernel": (("model", None), (10240, 1))},
    "calciumgan2d": {
        "generator/Dense_0/kernel": ((None, "model"), (32, 104448)),
        "discriminator/Dense_0/kernel": (("model", None), (32640, 1))},
    "mlp": {
        "discriminator/Dense_0/kernel": ((None, "model"), (2, 128)),
        "discriminator/Dense_4/kernel": (("model", None), (192, 1))},
}


@pytest.mark.parametrize("model", list(DEFAULT_SHARDED))
def test_default_widths_shard_what_jax_shards(model):
    sizes = _default(model)
    assert _port_sharded(sizes, 2) == _jax_sharded(sizes, 2) \
        == DEFAULT_SHARDED[model]


@pytest.mark.parametrize("sizes,mp", [
    (tiny(model_parallelism=2), 2), (tiny(), 4),
    (tiny(**CASES["long"]), 2), (tiny(**CASES["long"]), 8),
    (sizes_of(**CASES["mlp"]), 2), (sizes_of(**CASES["2d"]), 2)])
def test_tiny_configurations_shard_what_jax_shards(sizes, mp):
    """The tiny configurations on model axes of 2, 4 and 8."""
    assert _port_sharded(sizes, mp) == _jax_sharded(sizes, mp)


def test_mlp_case_shards_the_critic_input_layer_by_columns():
    """The mlp cases' step runs the output-column branch of
    ``sharded_dense`` on an input that takes a gradient (the penalty's
    and the generator's through the critic), as JAX shards it."""
    for name in ("mlp", "mlp-gan"):
        sharded = _jax_sharded(sizes_of(**CASES[name]), 2)
        assert sharded["discriminator/Dense_0/kernel"] == (
            (None, "model"), (2, 16))
        assert SHARDS[name]["discriminator/dense_0.weight"] == (8, 2)


def test_indivisible_dimension_is_replicated_as_jax_does():
    sizes = tiny()  # the head has 40 rows: 3 does not divide them
    assert _jax_sharded(sizes, 3) == {} == _port_sharded(sizes, 3)
    assert mesh_lib.state_shardings(
        {("Dense_0", "kernel"): (40, 1)}, 3) == {("Dense_0", "kernel"): ()}
    assert mesh_lib.state_shardings(
        {("Dense_0", "kernel"): (40, 1)}, 2) == {
            ("Dense_0", "kernel"): ("model", None)}
    assert mesh_lib.param_spec(("Conv_0", "kernel"), (4, 6, 4)) == ()
    assert mesh_lib.param_spec(("Dense_1", "bias"), (6,)) == ()


# ---- steps -----------------------------------------------------------------

def _once(draws):
    """A ``gan`` step's draws as the port takes them: JAX traces the one
    forward pass under both gradients, so it records each draw twice."""
    out = {}
    for kind, values in draws.items():
        half = len(values) // 2
        assert len(values) == 2 * half, kind
        for a, b in zip(values[:half], values[half:]):
            np.testing.assert_array_equal(a, b)
        out[kind] = values[:half]
    return out


def _jax_reference(kw):
    """JAX's unsharded train and eval steps from the shared weights, and
    the draws each recorded; the EMA after the step where ``kw`` keeps
    one, as the port's (Flax) variables."""
    sizes = sizes_of(**kw)
    real = real_batch(8, shape=tuple(sizes["signal_shape"]))
    with recording() as rec:
        _, _, jalgo, jstate = make_pair(rec, **kw)
        if kw.get("ema"):
            jstate = jstate.replace(ema_params=jax.tree.map(
                jnp.copy, jstate.generator.params))
        new, logs = jax.jit(jalgo.train_step)(jstate, jnp.asarray(real),
                                              jax.random.PRNGKey(0))
        train_draws = rec.take()
        if kw.get("algorithm") == "gan":
            train_draws = _once(train_draws)
        _, elogs = jax.jit(jalgo.eval_step)(
            jstate, jnp.asarray(real), jax.random.PRNGKey(5),
            jnp.asarray(EVAL_MASK))
        eval_draws = rec.take()
    ema = None if new.ema_params is None else jax.tree.map(
        np.asarray, new.ema_params)
    return dict(sizes=sizes, real=real, logs=jax.tree.map(float, logs),
                eval_logs=jax.tree.map(float, elogs),
                train_draws=train_draws, eval_draws=eval_draws, ema=ema)


@pytest.fixture(scope="module")
def jax_steps():
    return {name: _jax_reference(kw) for name, kw in CASES.items()}


@pytest.fixture(scope="module")
def runs(records, tmp_path_factory):  # noqa: F811
    """``main --model_parallelism 2`` run dirs: ``mp`` trained by 2 ranks
    for 2 epochs with ``--plot_weights``, ``one`` its one-process twin;
    ``resumed`` trained 1 epoch by one process, then to 2 by 2 ranks."""
    root = tmp_path_factory.mktemp("mp_runs")
    mp, resumed, one = (str(root / n) for n in ("mp", "resumed", "one"))
    port_main.cli(flags(records, resumed, 1))
    port_main.cli(flags(records, one, 2, "--plot_weights"))
    configs = {name: port_main.parse_args(flags(
        records, run, 2, "--model_parallelism", "2", *extra))[0]
        for name, run, extra in (("mp", mp, ("--plot_weights",)),
                                 ("resumed", resumed, ()))}
    return dict(mp=mp, resumed=resumed, one=one, configs=configs)


@pytest.fixture(scope="module")
def rank_results(jax_steps, runs):
    two = []
    for name, ref in jax_steps.items():
        two.append(((name, "step"), ranks.rank_parallel_step,
                    (ref["sizes"], ref["real"], 2, 1, ref["train_draws"])))
        two.append(((name, "eval"), ranks.rank_parallel_eval,
                    (ref["sizes"], ref["real"], EVAL_MASK, 2, 1,
                     ref["eval_draws"])))
    two.append((("long", "tables"), ranks.rank_layer_tables,
                (jax_steps["long"]["sizes"],)))
    layout = mesh_lib.create_mesh(1, 2, ["cpu"] * 2)
    for name in ("mp", "resumed"):
        two.append(((name, "train"), ranks.rank_train,
                    (runs["configs"][name], layout)))
    two.append((("batch_norm", "peers"), ranks.rank_batch_norm_peers,
                (BN_ROWS, 2)))
    ref = jax_steps["tiny"]
    four = [(("tiny", "step"), ranks.rank_parallel_step,
             (ref["sizes"], ref["real"], 2, 1, ref["train_draws"])),
            (("batch_norm", "peers"), ranks.rank_batch_norm_peers,
             (BN_ROWS, 2))]
    return dict(
        two=launch_lib.launch(ranks.rank_jobs, ["cpu"] * 2, "gloo",
                              args=(two,), timeout=TIMEOUT),
        four=launch_lib.launch(ranks.rank_jobs, ["cpu"] * 4, "gloo",
                               args=(four,), timeout=TIMEOUT))


def _held_logs(ref_logs, simultaneous: bool) -> list:
    """The logs held to JAX's: the critic loss and the penalty, and the
    generator loss where both losses come from one forward pass (``gan``;
    WGAN-GP's generator loss follows the critic's updates)."""
    keys = ["loss/discriminator", "loss/gradient_penalty"]
    if simultaneous:
        keys.append("loss/generator")
    return [k for k in keys if k in ref_logs]


def _check_step(results, ref, shards):
    first = results[0]["tensors"]
    for res in results:
        assert res["left"] == {}, "every recorded draw replayed"
        assert res["shards"] == shards
        assert set(res["tensors"]) == set(first)
        for k, v in res["tensors"].items():  # replicas equal bit for bit
            assert v.tobytes() == first[k].tobytes(), k
        assert set(res["logs"]) == set(ref["logs"])
        simultaneous = ref["sizes"]["algorithm"] == "gan"
        for k in _held_logs(ref["logs"], simultaneous):
            np.testing.assert_allclose(res["logs"][k], ref["logs"][k],
                                       rtol=RTOL, err_msg=k)


HEAD = {"discriminator/dense.weight": (1, 20)}
LONG_SHARDS = {"generator/dense_0.weight": (32, 8),
               "generator/dense_0.bias": (32,),
               "discriminator/dense.weight": (1, 80)}
MLP_SHARDS = {"discriminator/dense_0.weight": (8, 2),
              "discriminator/dense_0.bias": (8,),
              "discriminator/dense_4.weight": (1, 12)}
SHARDS = {"tiny": HEAD, "long": LONG_SHARDS, "long-ema": LONG_SHARDS,
          "mlp": MLP_SHARDS, "mlp-gan": MLP_SHARDS,
          "2d": {"generator/dense_0.weight": (24, 4),
                 "generator/dense_0.bias": (24,),
                 "discriminator/dense.weight": (1, 30)},
          "gan": HEAD, "batch_norm": HEAD}


@pytest.mark.parametrize("launch", ["two", "four"])
def test_batch_norm_statistics_equal_on_every_rank(rank_results, launch):
    """Model peers whose activations differ in the last bits keep the same
    running statistics, those of the global batch with each peer's rows
    counted once: BatchNorm sums its moments over every rank, not over
    the data group alone (over which each peer kept its own)."""
    found = [r[("batch_norm", "peers")] for r in rank_results[launch]]
    for other in found[1:]:
        for name, value in other.items():
            assert value.tobytes() == found[0][name].tobytes(), name
    # the two peers' rows, 1 and 1 + 2**-20 times the batch, in equal shares
    x = BN_ROWS.astype(np.float64) * (1.0 + 2.0 ** -21)
    mean = x.mean(axis=(0, 2))
    var = (x * x).mean(axis=(0, 2)) - mean ** 2
    np.testing.assert_allclose(found[0]["mean"], 0.01 * mean, rtol=1e-5)
    np.testing.assert_allclose(found[0]["var"], 0.99 + 0.01 * var,
                               rtol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_model_step_matches_jax(rank_results, jax_steps, name):
    _check_step([r[(name, "step")] for r in rank_results["two"]],
                jax_steps[name], SHARDS[name])
    counted = rank_results["two"][0][(name, "step")]["collectives"]
    head_only = rank_results["two"][0][("tiny", "step")]["collectives"]
    # the model axis's: an all-reduce for each critic head pass forward, a
    # gather for each backward through the head's replicated input, and
    # one more a generator pass when its projection is sharded
    assert counted["all_reduce"] > 0 and counted["all_gather"] > 0
    if name in ("long", "long-ema", "2d"):
        assert counted["all_gather"] > head_only["all_gather"]


def test_two_rank_ema_is_jax_ema(rank_results, jax_steps):
    """The EMA of the sharded generator projection, gathered whole, is
    JAX's after the step: each rank keeps its own block."""
    ref = jax_steps["long-ema"]
    tensors = rank_results["two"][0][("long-ema", "step")]["tensors"]
    ema = {k.split("/", 1)[1]: torch.from_numpy(v)
           for k, v in tensors.items() if k.startswith("ema/")}
    assert "dense_0.weight" in ema
    ours = convert.flax_generator_params(ema)
    flat = dict(jax.tree_util.tree_leaves_with_path(ref["ema"]))
    assert len(jax.tree_util.tree_leaves(ours)) == len(flat)
    for path, theirs in flat.items():
        mine = ours
        for p in path:
            mine = mine[p.key]
        np.testing.assert_allclose(np.asarray(mine), theirs, rtol=0,
                                   atol=EMA_ATOL, err_msg=str(path))


def test_four_rank_data_and_model_step_matches_jax(rank_results, jax_steps):
    _check_step([r[("tiny", "step")] for r in rank_results["four"]],
                jax_steps["tiny"], HEAD)


@pytest.mark.parametrize("name", list(CASES))
def test_model_parallel_eval_step_matches_jax(rank_results, jax_steps,
                                              name):
    ref = jax_steps[name]
    for res in rank_results["two"]:
        got = res[(name, "eval")]["logs"]
        assert set(got) == set(ref["eval_logs"])
        for k in ("loss/generator", "loss/discriminator",
                  "loss/gradient_penalty"):
            if k not in ref["eval_logs"]:
                continue
            np.testing.assert_allclose(got[k], ref["eval_logs"][k],
                                       rtol=RTOL, err_msg=k)
        assert got["batch/real_rows"] == 5.0


# ---- what a model-parallel run reports ----------------------------------------

WEIGHT_RTOL = 1e-5  # weight statistics after 2 epochs vs one process


def test_model_parallel_run_reports_whole_parameters(rank_results, runs):
    """The parameter counts and ``--plot_weights`` statistics of the
    2-rank run are the one-process run's: whole parameters, the sharded
    ones gathered, not rank 0's shards."""
    ours, theirs = (read_scalars(runs[n]) for n in ("mp", "one"))
    counts = [t for t in theirs if t.startswith("model/trainable")]
    assert len(counts) == 2
    for tag in counts:
        assert ours[tag] == theirs[tag], tag
    stats = sorted(t for t in theirs if t.startswith("plots_"))
    assert sorted(t for t in ours if t.startswith("plots_")) == stats
    # the critic head (discriminator/dense.weight) is sharded by rows
    head = [t for t in stats if t.endswith("/dense.weight/0_mean")
            and t.startswith("plots_discriminator")]
    assert len(head) == 1
    for tag in stats:
        assert set(ours[tag]) == set(theirs[tag]) == {0, 1}, tag
        for step, value in theirs[tag].items():
            np.testing.assert_allclose(ours[tag][step], value,
                                       rtol=WEIGHT_RTOL, atol=1e-7,
                                       err_msg=f"{tag} step {step}")


def test_layer_table_shows_whole_shapes(rank_results):
    """``--verbose 2``'s table and the parameter counts of a model-2 rank
    (the ``long`` case: projection and head sharded) are a one-process
    net's: whole shapes."""
    cfg = Config(**tiny(**CASES["long"]))
    nets = dict(zip(("generator", "discriminator"), get_models(
        cfg, rng=torch.Generator().manual_seed(0))))
    for res in rank_results["two"]:
        tables, shards = res[("long", "tables")]
        assert shards == SHARDS["long"]
        for name, net in nets.items():
            assert tables[name] == (train_lib.layer_table(net),
                                    train_lib.count_params(net))
    assert "weight (1, 160)" in tables["discriminator"][0]


# ---- checkpoints -----------------------------------------------------------

def _stored(run, epoch):
    return torch.load(checkpoint.port_checkpoint_path(
        os.path.join(run, "checkpoints"), epoch), weights_only=True)


def test_model_parallel_checkpoint_is_a_one_process_one(rank_results, runs,
                                                        records,  # noqa
                                                        tmp_path):
    run = runs["mp"]
    stored = _stored(run, 1)
    one_process = _stored(runs["resumed"], 0)  # the same configuration
    for name in ("generator", "discriminator"):
        params = stored[name]["params"]
        shapes = {n: tuple(t.shape) for n, t in
                  one_process[name]["params"].items()}
        assert {n: tuple(t.shape) for n, t in params.items()} == shapes
        order = list(params)
        for i, moments in stored[name]["opt_state"]["state"].items():
            assert tuple(moments["exp_avg"].shape) == shapes[order[i]]
    # a one-process run resumes it, and generate serves it
    port_main.cli(flags(records, run, 3))
    with open(os.path.join(run, "checkpoints", "latest.json")) as f:
        assert json.load(f)["epoch"] == 2
    out = generate_mod.cli(["--output_dir", run, "--num_samples", "3",
                            "--batch_size", "2", "--device", "cpu",
                            "--out", str(tmp_path / "s.npys"),
                            "--verbose", "0"])
    served = h5.get(out, "signals")
    assert served.shape == (3, 32, 4) and np.isfinite(served).all()


def test_model_parallel_run_resumes_a_one_process_checkpoint(rank_results,
                                                             runs):
    run = runs["resumed"]
    assert checkpoint.latest_epoch(os.path.join(run, "checkpoints")) == 1
    stored, first = _stored(run, 1), _stored(run, 0)
    assert stored["global_step"] == 2 * first["global_step"]
    head = stored["discriminator"]["params"]["dense.weight"]
    assert tuple(head.shape) == tuple(
        first["discriminator"]["params"]["dense.weight"].shape) == (1, 10)
