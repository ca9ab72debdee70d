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
- a 2-rank model-2 step (the tiny configuration, and one of 256 frames
  whose generator input projection is sharded too) and a 4-rank data-2 x
  model-2 step, replaying the JAX step's draws: the critic loss and
  penalty within rtol 1e-4 of JAX's unsharded ``train_step``, as the JAX
  package's own model-parallel test holds its mesh to it, and the eval
  step's losses likewise (``tests/test_algorithms.py:226-245``); every
  rank's tensors equal bit for bit, the shards' gathered whole;
- ``main --model_parallelism 2`` in 2 gloo ranks writes the checkpoint a
  one-process run writes (whole tensors), which a one-process run resumes
  and ``generate`` serves; 2 ranks resume a one-process checkpoint, each
  keeping its block.

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
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.parallel import launch as launch_lib
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import checkpoint, h5
import torch_rank_helpers as ranks
from test_torch_multiprocess import flags, records  # noqa: F401 (fixture)
from torch_step_helpers import make_pair, real_batch, recording, tiny

torch.set_num_threads(1)

TIMEOUT = 300
RTOL = 1e-4  # critic loss, penalty and eval losses vs JAX's unsharded step
CASES = {"tiny": dict(n_critic=1),
         "long": dict(n_critic=1, sequence_length=256,
                      signal_shape=(256, 6))}
EVAL_MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)


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
    (tiny(**CASES["long"]), 2), (tiny(**CASES["long"]), 8)])
def test_tiny_configurations_shard_what_jax_shards(sizes, mp):
    """The tiny configurations on model axes of 2, 4 and 8."""
    assert _port_sharded(sizes, mp) == _jax_sharded(sizes, mp)


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

def _jax_reference(kw):
    """JAX's unsharded train and eval steps from the shared weights, and
    the draws each recorded."""
    sizes = tiny(**kw)
    real = real_batch(8, shape=tuple(sizes["signal_shape"]))
    with recording() as rec:
        _, _, jalgo, jstate = make_pair(rec, **kw)
        _, logs = jax.jit(jalgo.train_step)(jstate, jnp.asarray(real),
                                            jax.random.PRNGKey(0))
        train_draws = rec.take()
        _, elogs = jax.jit(jalgo.eval_step)(
            jstate, jnp.asarray(real), jax.random.PRNGKey(5),
            jnp.asarray(EVAL_MASK))
        eval_draws = rec.take()
    return dict(sizes=sizes, real=real, logs=jax.tree.map(float, logs),
                eval_logs=jax.tree.map(float, elogs),
                train_draws=train_draws, eval_draws=eval_draws)


@pytest.fixture(scope="module")
def jax_steps():
    return {name: _jax_reference(kw) for name, kw in CASES.items()}


@pytest.fixture(scope="module")
def runs(records, tmp_path_factory):  # noqa: F811
    """``main --model_parallelism 2`` run dirs: ``mp`` trained by 2 ranks
    for 2 epochs; ``resumed`` trained 1 epoch by one process, then to 2
    by 2 ranks."""
    root = tmp_path_factory.mktemp("mp_runs")
    mp, resumed = str(root / "mp"), str(root / "resumed")
    port_main.cli(flags(records, resumed, 1))
    configs = {name: port_main.parse_args(flags(
        records, run, 2, "--model_parallelism", "2"))[0]
        for name, run in (("mp", mp), ("resumed", resumed))}
    return dict(mp=mp, resumed=resumed, configs=configs)


@pytest.fixture(scope="module")
def rank_results(jax_steps, runs):
    two = []
    for name, ref in jax_steps.items():
        two.append(((name, "step"), ranks.rank_parallel_step,
                    (ref["sizes"], ref["real"], 2, 1, ref["train_draws"])))
        two.append(((name, "eval"), ranks.rank_parallel_eval,
                    (ref["sizes"], ref["real"], EVAL_MASK, 2, 1,
                     ref["eval_draws"])))
    layout = mesh_lib.create_mesh(1, 2, ["cpu"] * 2)
    for name in ("mp", "resumed"):
        two.append(((name, "train"), ranks.rank_train,
                    (runs["configs"][name], layout)))
    ref = jax_steps["tiny"]
    four = [(("tiny", "step"), ranks.rank_parallel_step,
             (ref["sizes"], ref["real"], 2, 1, ref["train_draws"]))]
    return dict(
        two=launch_lib.launch(ranks.rank_jobs, ["cpu"] * 2, "gloo",
                              args=(two,), timeout=TIMEOUT),
        four=launch_lib.launch(ranks.rank_jobs, ["cpu"] * 4, "gloo",
                               args=(four,), timeout=TIMEOUT))


def _check_step(results, ref, shards):
    first = results[0]["tensors"]
    for res in results:
        assert res["left"] == {}, "every recorded draw replayed"
        assert res["shards"] == shards
        for k, v in res["tensors"].items():  # replicas equal bit for bit
            assert v.tobytes() == first[k].tobytes(), k
        assert set(res["logs"]) == set(ref["logs"])
        for k in ("loss/discriminator", "loss/gradient_penalty"):
            np.testing.assert_allclose(res["logs"][k], ref["logs"][k],
                                       rtol=RTOL, err_msg=k)


HEAD = {"discriminator/dense.weight": (1, 20)}
SHARDS = {"tiny": HEAD,
          "long": {"generator/dense_0.weight": (32, 8),
                   "generator/dense_0.bias": (32,),
                   "discriminator/dense.weight": (1, 80)}}


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
    if name == "long":
        assert counted["all_gather"] > head_only["all_gather"]


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
            np.testing.assert_allclose(got[k], ref["eval_logs"][k],
                                       rtol=RTOL, err_msg=k)
        assert got["batch/real_rows"] == 5.0


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
