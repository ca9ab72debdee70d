"""The port's data axis (``calciumgan_tpu_torch.parallel``) against the JAX
package's ``parallel/mesh.py`` and against its own one-process step.

- ``create_mesh``, ``data_extent``, ``local_batch_size`` and
  ``pad_to_multiple`` give the JAX functions' layouts, values and errors
  on the same arguments (the port's ranks in the order of the JAX mesh's
  devices, slices included);
- rank r's draws are rows r of the one-process draws (noise, GP alpha,
  dropout masks of a ``concat(real, fake)`` pass), its shifts the same;
- a 2-rank gloo step equals the one-process step at the global batch 8:
  at learning rate 0 (every quantity taken at the shared weights) the logs
  within 1e-5 relative and Adam's first moments within 1e-5 of each
  tensor's largest (a bias before a BatchNorm, whose gradient is 0 but for
  rounding, within 1e-4 of the net's largest moment); at the tiny learning
  rate 1e-5 the parameters within 2 lr of the one process's (Adam's first step is about ``lr *
  sign(g)``, so a gradient near its epsilon that rounds otherwise moves
  a parameter by up to lr) and equal bit for bit across the ranks; for
  wgan-gp calciumgan, for gan + mlp with dropout and for a ``--batch_norm``
  generator (running statistics within 1e-6);
- the same 2-rank step against JAX's ``make_step_fns`` on
  ``create_mesh(data_parallelism=2)``, replaying the JAX step's draws, at
  ``test_torch_train_step.py``'s bounds;
- ``--dcn_slices 2``: two ranks at ``create_mesh(1, slices=2)`` get the
  rows JAX's ``create_mesh(1, devices[:2], slices=2)`` gives each slice,
  make the data-2 step's collectives and bits, and hold to JAX's step on
  that mesh (same bounds) and to the one-process step (the bounds above);
- a masked evaluation batch whose real rows split unevenly between the
  ranks gives the one-process logs and the global real-row count;
- a rank's rows of a batch, gathered from every rank, are the batch;
- the launcher hands a rank's exception to the caller and kills a hung
  rank's siblings after its timeout; a run of one device joins no group.

All rank work of the module runs in ONE launch of two gloo ranks on the
host (``torch_rank_helpers.rank_jobs``), so process start-up is paid once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from calciumgan_tpu.algorithms import get_algorithm as jax_get_algorithm
from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.models import get_models as jax_get_models
from calciumgan_tpu.parallel import mesh as jax_mesh
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.algorithms.gan import Draws, ShardDraws
from calciumgan_tpu_torch.parallel import launch as launch_lib
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
import torch_rank_helpers as ranks
from test_torch_train_step import F32_GRAD_TOL, LOSS_ATOL, LOSS_RTOL
from torch_step_helpers import make_pair, real_batch, recording, tiny, \
    tiny_mlp

torch.set_num_threads(1)

LR = 1e-5            # the tiny configuration's
STEP_RTOL = 1e-5     # logs, 2 ranks vs 1 process, at learning rate 0
MOMENT_TOL = 1e-5    # of each tensor's largest moment, likewise
STATS_TOL = 1e-6     # BatchNorm running statistics
ZERO_GRAD_TOL = 1e-4  # of the net's largest moment (test_torch_batch_norm)
WORLD = 2

CASES = {
    "wgan-gp": tiny(),
    "gan-mlp-dropout": tiny_mlp(algorithm="gan"),
    "batch-norm": tiny(batch_norm=True, n_critic=5),
}


def _real(sizes):
    return real_batch(8, shape=tuple(sizes["signal_shape"]))


def _once(draws):
    """The vanilla GAN's one forward, traced under both gradients in JAX:
    its noise and shifts are recorded twice and replayed once."""
    half = {k: len(v) // 2 for k, v in draws.items()}
    return {k: v[:half[k]] for k, v in draws.items()}


def _jax_mesh_step(kw, slices=1):
    """JAX's train step on ``create_mesh(data_parallelism=2)`` (with
    ``slices``: ``create_mesh(2 // slices, devices=jax.devices()[:2],
    slices=slices)``) from the shared weights, the draws recorded from the
    same step on one device (an ordered callback is refused on more than
    one device; the draws do not depend on the sharding), and each mesh
    device's rows of the batch, in the mesh's device order."""
    real = jnp.asarray(_real(tiny(**kw)))
    with recording() as rec:
        _, _, jalgo, jstate = make_pair(rec, **kw)
        jax.jit(jalgo.train_step)(jstate, real, jax.random.PRNGKey(1))
        draws = rec.take()
    jcfg = JaxConfig(**tiny(**kw))
    algo = jax_get_algorithm(jcfg, *jax_get_models(jcfg))
    mesh = (jax_mesh.create_mesh(data_parallelism=WORLD) if slices == 1
            else jax_mesh.create_mesh(WORLD // slices,
                                      devices=jax.devices()[:WORLD],
                                      slices=slices))
    train, _, _ = jax_mesh.make_step_fns(algo, mesh, jstate)
    state = jax.device_put(jstate, jax_mesh.state_shardings(mesh, jstate))
    batch = jax_mesh.shard_batch(mesh, np.asarray(real))
    shards = {s.device.id: np.asarray(s.data)
              for s in batch.addressable_shards}
    rows = [shards[d.id] for d in mesh.devices.flat]
    new, logs = train(state, batch, jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, (new, logs)) + (draws, rows)


JAX_CASES = {"wgan-gp": {}, "batch-norm": dict(batch_norm=True)}


@pytest.fixture(scope="module")
def jax_steps():
    return {name: _jax_mesh_step(kw) for name, kw in JAX_CASES.items()}


@pytest.fixture(scope="module")
def jax_sliced():
    """JAX's wgan-gp step on two slices of one device each."""
    return _jax_mesh_step({}, slices=WORLD)


@pytest.fixture(scope="module")
def rank_results(jax_steps, jax_sliced):
    """Every rank job of the module in one launch of two gloo ranks: each
    case's step at learning rate 0 and at the tiny rate, the JAX cases'
    steps on the recorded draws, the masked evaluation, and the wgan-gp
    step on two slices at learning rate 0 and on JAX's sliced draws."""
    jobs = []
    for name, sizes in CASES.items():
        for lr in (0.0, LR):
            jobs.append(((name, lr), ranks.rank_step,
                         (dict(sizes, learning_rate=lr), _real(sizes))))
    for name, (_, _, draws, _) in jax_steps.items():
        sizes = tiny(**JAX_CASES[name])
        jobs.append(((name, "jax"), ranks.rank_step,
                     (sizes, _real(sizes), draws)))
    jobs.append(("eval", ranks.rank_evaluate,
                 (tiny(), _real(tiny()), _EVAL_MASK, 3, 17)))
    jobs.append(("gather", ranks.rank_gather, (_real(tiny()),)))
    # (sizes, real, model, time, recorded, seed, counter, slices)
    jobs.append((("slices", 0.0), ranks.rank_parallel_step,
                 (tiny(learning_rate=0.0), _real(tiny()), 1, 1, None, 0, 0,
                  WORLD)))
    jobs.append((("slices", "jax"), ranks.rank_parallel_step,
                 (tiny(), _real(tiny()), 1, 1, jax_sliced[2], 0, 0, WORLD)))
    return launch_lib.launch(ranks.rank_jobs, ["cpu"] * WORLD, "gloo",
                             args=(jobs,), timeout=300)


# ---- layouts -------------------------------------------------------------

@pytest.mark.parametrize("dp,slices,n", [
    (-1, 1, 8), (2, 1, 8), (4, 1, 4), (-1, 2, 8), (1, 4, 8), (2, 2, 8),
    (3, 2, 8)])
def test_create_mesh_equals_jax(dp, slices, n):
    theirs = jax_mesh.create_mesh(dp, devices=jax.devices()[:n],
                                  slices=slices)
    ours = mesh_lib.create_mesh(dp, devices=[f"cuda:{i}" for i in range(n)],
                                slices=slices)
    assert [f"cuda:{d.id}" for d in theirs.devices.flat] == list(ours.devices)
    assert mesh_lib.data_extent(ours) == jax_mesh.data_extent(theirs)
    assert len(ours.devices) == theirs.devices.size


@pytest.mark.parametrize("dp,slices,n", [(-1, 3, 8), (5, 1, 4), (3, 2, 4),
                                         (2, 3, 4)])
def test_create_mesh_refuses_as_jax_does(dp, slices, n):
    with pytest.raises(ValueError) as theirs:
        jax_mesh.create_mesh(dp, devices=jax.devices()[:n], slices=slices)
    with pytest.raises(ValueError) as ours:
        mesh_lib.create_mesh(dp, devices=["cpu"] * n, slices=slices)
    assert str(ours.value) == str(theirs.value)


def test_model_parallelism_refuses_as_jax_does():
    # the model axis is ported (tests/test_torch_model_parallel.py): a
    # layout the devices cannot hold raises JAX's error
    with pytest.raises(ValueError) as theirs:
        jax_mesh.create_mesh(-1, 3, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as ours:
        mesh_lib.create_mesh(-1, 3, devices=["cpu"] * 4)
    assert str(ours.value) == str(theirs.value) == \
        "4 devices/slice not divisible by model_parallelism 3"


def test_local_batch_size_and_padding_equal_jax(monkeypatch):
    for batch in (8, 64, 128):
        assert mesh_lib.local_batch_size(batch) == \
            jax_mesh.local_batch_size(batch)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 3)
    assert mesh_lib.local_batch_size(6) == jax_mesh.local_batch_size(6) == 2
    for fn in (mesh_lib.local_batch_size, jax_mesh.local_batch_size):
        with pytest.raises(ValueError, match="batch_size 8 not divisible "
                                             "by process count 3"):
            fn(8)
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    for multiple in (1, 2, 4, 5, 8):
        ours, theirs = (mesh_lib.pad_to_multiple(x, multiple),
                        jax_mesh.pad_to_multiple(x, multiple))
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]


def test_shard_draws_are_rows_of_the_global_draws():
    local, world = 4, 2
    whole = Draws(9, 3, "cpu")
    noise, alpha = whole.noise(local * world, 8), whole.alpha(local * world)
    keep = whole.dropout((2 * local * world, 6, 5), 0.2)  # concat(real, fake)
    shifts = whole.shifts(2, 4)
    for rank in range(world):
        part = ShardDraws(Draws(9, 3, "cpu"), rank, world, local)
        rows = slice(rank * local, (rank + 1) * local)
        torch.testing.assert_close(part.noise(local, 8), noise[rows],
                                   rtol=0, atol=0)
        torch.testing.assert_close(part.alpha(local), alpha[rows],
                                   rtol=0, atol=0)
        real_rows = keep[:local * world][rows]
        fake_rows = keep[local * world:][rows]
        assert torch.equal(part.dropout((2 * local, 6, 5), 0.2),
                           torch.cat([real_rows, fake_rows]))
        assert part.shifts(2, 4) == shifts


# ---- steps -----------------------------------------------------------------

def _moment_err(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _zero_gradient(sizes, name):
    """A generator bias that feeds a BatchNorm: its gradient is 0 but for
    rounding, so it is held near 0 instead (``test_torch_batch_norm``)."""
    return bool(sizes.get("batch_norm")) and name.startswith(
        "conv_transpose.") and name.endswith(".bias")


def _check_moment(ours, ref, scale, tol, sizes, name):
    """A first moment within ``tol`` of its tensor's largest; a zero
    gradient within ``ZERO_GRAD_TOL`` of the net's largest ``scale``."""
    if _zero_gradient(sizes, name):
        assert max(float(np.abs(ours).max()), float(np.abs(ref).max())) \
            <= ZERO_GRAD_TOL * scale, name
    else:
        assert _moment_err(ours, ref) <= tol, name


def _assert_one_process_step(got, one, sizes, lr):
    """A rank's step (``got``) against the one-process step ``one`` at
    learning rate ``lr``: logs and moments at 0, parameters within 2 lr,
    running statistics within ``STATS_TOL``."""
    if lr == 0.0:
        for k, v in one["logs"].items():
            np.testing.assert_allclose(got["logs"][k], v, rtol=STEP_RTOL,
                                       atol=0, err_msg=k)
    for k, v in one["tensors"].items():
        if "/moment/" in k and lr == 0.0:
            net = k.split("/")[0]
            scale = max(float(np.abs(t).max()) for n, t in
                        one["tensors"].items()
                        if n.startswith(f"{net}/moment/"))
            _check_moment(got["tensors"][k], v, scale, MOMENT_TOL,
                          sizes if net == "generator" else {},
                          k.split("/")[-1])
        elif "/buffer/" in k:
            np.testing.assert_allclose(got["tensors"][k], v, rtol=0,
                                       atol=STATS_TOL, err_msg=k)
        elif "/moment/" not in k:
            np.testing.assert_allclose(got["tensors"][k], v, rtol=0,
                                       atol=2 * lr, err_msg=k)


def _assert_replicas_equal(results, key):
    first = results[0][key]["tensors"]
    for rank, res in enumerate(results):
        for k, v in res[key]["tensors"].items():
            assert v.tobytes() == first[k].tobytes(), (key, rank, k)


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_equals_one_process(rank_results, name):
    sizes = CASES[name]
    for lr in (0.0, LR):
        one = ranks.step(dict(sizes, learning_rate=lr), _real(sizes),
                         Draws(0, 0, "cpu"))
        _assert_replicas_equal(rank_results, (name, lr))
        for res in rank_results:
            got = res[(name, lr)]
            assert got["collectives"]["all_reduce"] > 0
            _assert_one_process_step(got, one, sizes, lr)
    if sizes.get("batch_norm"):  # the statistics moved, 6 times
        assert any(float(np.abs(v - (1.0 if k.endswith("var") else 0.0))
                         .max()) > 1e-4 for k, v in one["tensors"].items()
                   if "/buffer/" in k)


def _assert_jax_step(got, new, jlogs, sizes):
    """A rank's step on JAX's recorded draws against JAX's mesh step: the
    logs at ``test_torch_train_step.py``'s bounds, each first moment within
    its tensor's largest, the running statistics within ``STATS_TOL``."""
    to_g = convert.generator_state_dict
    to_d = convert.discriminator_state_dict
    assert got["left"] == {}, "every recorded draw replayed"
    assert set(got["logs"]) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(got["logs"][k], float(jlogs[k]),
                                   rtol=LOSS_RTOL[False],
                                   atol=LOSS_ATOL[False], err_msg=k)
    for net, to_sd in (("generator", to_g), ("discriminator", to_d)):
        mu = to_sd(getattr(new, net).opt_state[0].mu)
        scale = max(float(v.abs().max()) for v in mu.values())
        for n, ref in mu.items():
            _check_moment(got["tensors"][f"{net}/moment/{n}"],
                          np.asarray(ref), scale, F32_GRAD_TOL,
                          sizes if net == "generator" else {}, n)
    if sizes.get("batch_norm"):
        stats = to_g(new.generator.params, sizes["model"],
                     new.generator.batch_stats)
        for n, ref in stats.items():
            if "batch_norm.mean" in n or "batch_norm.var" in n:
                np.testing.assert_allclose(
                    got["tensors"][f"generator/buffer/{n}"],
                    np.asarray(ref), rtol=0, atol=STATS_TOL, err_msg=n)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_two_rank_step_matches_jax_data_mesh(rank_results, jax_steps, name):
    new, jlogs, _, _ = jax_steps[name]
    for res in rank_results:
        _assert_jax_step(res[(name, "jax")], new, jlogs,
                         tiny(**JAX_CASES[name]))


def test_sliced_ranks_get_the_rows_of_their_jax_slice(rank_results,
                                                      jax_sliced):
    # create_mesh(1, slices=2): rank r is slice r, and holds the rows JAX's
    # batch sharding over (slice, data) puts on that slice's device
    rows = jax_sliced[3]
    assert len(rows) == WORLD
    for rank, res in enumerate(rank_results):
        for key in (("slices", 0.0), ("slices", "jax")):
            np.testing.assert_array_equal(res[key]["rows"], rows[rank])


def test_sliced_step_matches_jax_and_one_process(rank_results, jax_sliced,
                                                 jax_steps):
    new, jlogs, _, _ = jax_sliced
    sizes = tiny()
    one = ranks.step(dict(sizes, learning_rate=0.0), _real(sizes),
                     Draws(0, 0, "cpu"))
    for key in (("slices", 0.0), ("slices", "jax")):
        _assert_replicas_equal(rank_results, key)
    for res in rank_results:
        _assert_one_process_step(res[("slices", 0.0)], one, sizes, 0.0)
        got = res[("slices", "jax")]
        _assert_jax_step(got, new, jlogs, sizes)
        # the slice axis folds into the data axis: the data-2 layout's
        # collectives, and its step bit for bit on the same draws
        data2 = res[("wgan-gp", "jax")]
        assert got["collectives"] == data2["collectives"]
        assert got["logs"] == data2["logs"]
        for k, v in data2["tensors"].items():
            assert got["tensors"][k].tobytes() == v.tobytes(), k


_EVAL_MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)


def test_masked_tail_split_unevenly_gives_one_process_logs(rank_results):
    # rank 0 holds 4 real rows, rank 1 one real row and 3 of filler
    one = ranks.evaluate(tiny(), _real(tiny()), _EVAL_MASK,
                         Draws(3, 17, "cpu"))
    assert one["batch/real_rows"] == 5.0
    for res in rank_results:
        got = res["eval"]
        assert set(got) == set(one)
        for k, v in one.items():
            np.testing.assert_allclose(got[k], v, rtol=STEP_RTOL, atol=1e-7,
                                       err_msg=k)


def test_rows_of_ranks_gather_back_to_the_global_batch(rank_results):
    real = _real(tiny())
    np.testing.assert_array_equal(
        np.concatenate([mesh_lib.rows_of(real, r, WORLD)
                        for r in range(WORLD)]), real)
    for res in rank_results:
        np.testing.assert_array_equal(res["gather"], real)
    with pytest.raises(ValueError, match="8 rows not divisible by 3"):
        mesh_lib.rows_of(real, 0, 3)


# ---- the launcher ---------------------------------------------------------

def test_launcher_raises_the_rank_error_and_stops_hung_ranks(tmp_path):
    with pytest.raises(ValueError, match="rank 1 fails") as failed:
        launch_lib.launch(ranks.rank_fail, ["cpu"] * WORLD, "gloo",
                          args=(1,), timeout=120,
                          store=str(tmp_path / "store1"))
    assert isinstance(failed.value.__cause__, launch_lib.RankFailed)
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] did not finish"):
        launch_lib.launch(ranks.rank_fail, ["cpu"] * WORLD, "gloo",
                          args=(None,), timeout=10,
                          store=str(tmp_path / "store2"))


def test_one_device_joins_no_group():
    mesh_lib.collectives.clear()
    ranks.step(tiny(), _real(tiny()), Draws(0, 0, "cpu"))
    assert not dist.is_initialized() and not mesh_lib.collectives
    layout = mesh_lib.create_mesh(-1, devices=mesh_lib.visible_devices(
        "cpu"))
    assert layout.devices == ("cpu",) and mesh_lib.data_extent(layout) == 1
    assert mesh_lib.data_group() is None and mesh_lib.process_count() == 1
