"""Long-context WGAN-GP training in the port
(``calciumgan_tpu_torch.parallel.long_context``) against the JAX
package's standard step and its ``make_long_context_algorithm``
(``tests/test_long_context.py``), at its ``lc_config`` widths (1024
frames, 3 neurons, units 2, kernel 24, noise 8, batch 8, n_critic 2):

- at m 0 the time-parallel step re-partitions the standard one, so in
  data 1 x time 2 ranks (and data 2 x time 2) its critic loss and penalty
  are JAX's unsharded step's within rtol 2e-4, replaying its draws; every
  rank's tensors equal bit for bit;
- an evaluation step's losses and generated batch (gathered whole) are
  the one-process long-context step's, whose passes are the same
  functions on the whole sequence;
- the three refusals (BatchNorm, an algorithm other than wgan-gp, a model
  other than calciumgan) with JAX's messages, and the layout's;
- ``python -m calciumgan_tpu_torch.main --time_parallelism 2 --device
  cpu`` trains on windows of 1024 frames end to end (as
  ``test_main_cli_time_parallelism``) and writes a checkpoint and an
  ``epoch000_signals`` file of whole 1024-frame rows.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.data import segments
from calciumgan_tpu.parallel.long_context import (
    create_time_mesh as jax_time_mesh,
    make_long_context_algorithm as jax_make)
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch import train as port_train
from calciumgan_tpu_torch.algorithms.gan import Draws
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.parallel import launch as launch_lib
from calciumgan_tpu_torch.parallel import long_context
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import checkpoint, h5
import torch_rank_helpers as ranks
from torch_step_helpers import make_pair, real_batch, recording, tiny

torch.set_num_threads(1)

TIMEOUT = 300
RTOL = 2e-4
LC = dict(sequence_length=1024, num_neurons=3, num_channels=3,
          signal_shape=(1024, 3), noise_dim=8, num_units=2, kernel_size=24,
          strides=2, m=0, batch_size=8, n_critic=2)
EVAL_MASK = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)


@pytest.fixture(scope="module")
def jax_step():
    real = real_batch(8, shape=LC["signal_shape"])
    with recording() as rec:
        _, _, jalgo, jstate = make_pair(rec, **LC)
        _, logs = jax.jit(jalgo.train_step)(jstate, jnp.asarray(real),
                                            jax.random.PRNGKey(3))
        draws = rec.take()
    return real, jax.tree.map(float, logs), draws


@pytest.fixture(scope="module")
def rank_results(jax_step):
    real, _, draws = jax_step
    sizes = tiny(**LC)
    jobs = [("step", ranks.rank_parallel_step, (sizes, real, 1, 2, draws)),
            ("eval", ranks.rank_parallel_eval,
             (sizes, real, EVAL_MASK, 1, 2, None, 4, 9))]
    return {world: launch_lib.launch(ranks.rank_jobs, ["cpu"] * world,
                                     "gloo", args=(jobs,), timeout=TIMEOUT)
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4], ids=["data1xtime2",
                                               "data2xtime2"])
def test_time_parallel_step_matches_jax_standard_step(rank_results,
                                                      jax_step, world):
    _, logs, _ = jax_step
    first = rank_results[world][0]["step"]["tensors"]
    for res in rank_results[world]:
        got = res["step"]
        assert got["left"] == {}, "every recorded draw replayed"
        assert got["shards"] == {}
        assert set(got["logs"]) == set(logs)
        for k in ("loss/discriminator", "loss/gradient_penalty"):
            np.testing.assert_allclose(got["logs"][k], logs[k], rtol=RTOL,
                                       err_msg=k)
        for k, v in got["tensors"].items():
            assert v.tobytes() == first[k].tobytes(), k
        # the halo exchanges ride all-gathers; no model shard was cut
        assert got["collectives"]["all_gather"] > 0


def test_time_parallel_eval_step_is_the_whole_sequence_step(rank_results,
                                                            jax_step):
    real, _, _ = jax_step
    cfg = Config(**dict(tiny(**LC), seed=0))
    gen, dis = get_models(cfg, rng=torch.Generator().manual_seed(0))
    algo = long_context.make_long_context_algorithm(cfg, gen, dis)
    assert algo.group is None  # one process: whole sequences
    fake, logs = algo.eval_step(algo.init_state(), torch.from_numpy(real),
                                Draws(4, 9, "cpu"),
                                torch.from_numpy(EVAL_MASK))
    for world, results in rank_results.items():
        rows = len(real) * 2 // world  # a data index's, time 2
        for rank, res in enumerate(results):
            got = res["eval"]
            block = rank // 2
            np.testing.assert_allclose(
                got["fake"], fake.numpy()[block * rows:(block + 1) * rows],
                atol=1e-6)
            for k, v in logs.items():
                np.testing.assert_allclose(got["logs"][k], float(v),
                                           rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("change", [
    dict(layer_norm=False, batch_norm=True), dict(algorithm="gan"),
    dict(model="mlp")], ids=["batch_norm", "gan", "mlp"])
def test_refusals_equal_jax(change):
    sizes = tiny(**dict(LC, **change))
    with pytest.raises(ValueError) as theirs:
        jax_make(JaxConfig(**sizes), jax_time_mesh(1, 8))
    cfg = Config(**sizes)
    gen, dis = get_models(cfg, rng=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as ours:
        long_context.make_long_context_algorithm(cfg, gen, dis)
    assert str(ours.value) == str(theirs.value)


def test_layouts_and_their_refusals_equal_jax():
    for dp, tp, n in ((1, -1, 8), (2, 4, 8), (2, -1, 8), (1, 2, 2)):
        theirs = jax_time_mesh(dp, tp, devices=jax.devices()[:n])
        ours = mesh_lib.create_time_mesh(dp, tp, [f"cuda:{i}"
                                                  for i in range(n)])
        assert [f"cuda:{d.id}" for d in theirs.devices.flat] == \
            list(ours.devices)
        assert (ours.data_parallelism, ours.time_parallelism) == \
            tuple(theirs.devices.shape)
    for dp, tp, n in ((3, -1, 8), (2, 8, 8)):
        with pytest.raises(ValueError) as theirs:
            jax_time_mesh(dp, tp, devices=jax.devices()[:n])
        with pytest.raises(ValueError) as ours:
            mesh_lib.create_time_mesh(dp, tp, ["cpu"] * n)
        assert str(ours.value) == str(theirs.value)
    config = Config(**tiny(**LC), time_parallelism=3, data_parallelism=-1)
    with pytest.raises(ValueError, match=r"time_parallelism 3 must divide "
                                         r"the device count \(2 device\(s\) "
                                         r"visible\)"):
        port_train.layout(config, ["cpu"] * 2)


@pytest.fixture(scope="module")
def long_records(tmp_path_factory):
    """``test_main_cli_time_parallelism``'s dataset: windows of 1024 of a
    3 x 6000 recording, 8 for validation."""
    rng = np.random.default_rng(1234)
    data = {"signals": rng.random((3, 6000)).astype(np.float32),
            "oasis": (rng.random((3, 6000)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 1024, 512, do_normalize=True, is_dg_data=True)
    out = str(tmp_path_factory.mktemp("lc") / "records")
    segments.write_dataset(out, signals, spikes, meta, 1024, 512,
                           validation_size=8, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    return out


def test_main_cli_time_parallelism(long_records, tmp_path):
    run = str(tmp_path / "lcrun")
    port_main.cli([
        "--input_dir", long_records, "--output_dir", run,
        "--batch_size", "4", "--num_units", "2", "--kernel_size", "24",
        "--noise_dim", "8", "--epochs", "1", "--n_critic", "1",
        "--model", "calciumgan", "--algorithm", "wgan-gp", "--m", "0",
        "--layer_norm", "--time_parallelism", "2", "--save_generated",
        "last", "--verbose", "0", "--device", "cpu"])
    assert checkpoint.latest_epoch(os.path.join(run, "checkpoints")) == 0
    assert os.path.exists(checkpoint.port_checkpoint_path(
        os.path.join(run, "checkpoints"), 0))
    files = glob.glob(os.path.join(run, "generated", "epoch000_signals*"))
    assert len(files) == 1  # one data index: one writer, no shard suffix
    fake = h5.get(files[0], "signals")
    assert fake.shape == (8, 1024, 3)
    assert np.isfinite(fake).all()
