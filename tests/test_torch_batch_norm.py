"""The port's BatchNorm (``Norm(batch_norm=True)``) against Flax's
``nn.BatchNorm`` as ``calciumgan_tpu.models.base.Norm`` applies it, and the
``--batch_norm`` 1-D model through the train steps, checkpoints and
``generate``.

- ``Norm`` forward in training (batch statistics, ``mutable=["batch_stats"]``)
  and in evaluation (running statistics), channels-last in Flax against
  channels-first here, on 3-D (NWC) and 4-D (NHWC) maps, float32 and
  bfloat16, with and without the LayerNorm after it; the running statistics
  after one update and after several;
- one vanilla-GAN step and one WGAN-GP step (n_critic 5) of the 1-D model
  with ``--batch_norm``, on replayed JAX draws: losses and gradients by the
  bounds of ``test_torch_train_step.py``, and the running statistics after
  the step's training passes (1 for the GAN, 6 for WGAN-GP);
- the statistics through ``convert``, the port's ``.pt`` resume, and the
  port's ``generate`` on a JAX ``--batch_norm --ema`` run.

Bounds:
- ``Norm`` outputs: float32 1e-5 absolute (the 1-D generator's bound; a
  statistic over B x W positions sums in another order); bfloat16 one
  rounding of the output, 2**-7 relative to a value just above a power of
  two (plus 1e-6): the port rounds where Flax does, but a float32 value
  within a reordering of a bfloat16 boundary may round to its neighbour
  (measured on 2 of 3072 values);
- running statistics: 1e-6 absolute (float32 sums of at most a few hundred
  values near 1, then ``0.99 r + 0.01 b``);
- the steps: ``test_torch_train_step.py``'s bounds, with two changes. The
  generator's ConvTranspose biases feed a BatchNorm, whose batch mean
  removes them: their gradient is 0 and their moments are rounding (1e-11
  here, 5e-8 in JAX), so they are held to 1e-4 of the net's largest moment
  (bfloat16: 0.1, its gradient bound; measured 0.01) and left out of the
  per-tensor bounds. And the WGAN-GP step's generator
  loss is read after 5 critic updates, each moving a parameter by up to
  ``lr`` where its gradient is near Adam's epsilon: its bound is 1e-5
  relative plus 5e-6 absolute (measured 1.6e-6 on 0.034; 5e-7 after the
  1-D test's 2 updates).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu import train as jax_train
from calciumgan_tpu.algorithms.registry import get_algorithm as jax_algorithm
from calciumgan_tpu.config import Config as JaxConfig
from calciumgan_tpu.data import pipeline as jax_pipeline
from calciumgan_tpu.data import segments
from calciumgan_tpu.models import base as jax_base
from calciumgan_tpu.models.registry import get_models as jax_get_models
from calciumgan_tpu.utils import checkpoint as jax_checkpoint
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch.algorithms import get_algorithm
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data.pipeline import reverse_preprocessing
from calciumgan_tpu_torch.models import base, get_models
from calciumgan_tpu_torch.utils import checkpoint
from test_torch_train_step import (LOSS_ATOL, LOSS_RTOL, check_logs,
                                   check_step, moments)
from torch_step_helpers import Replay, make_pair, real_batch, recording

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 1e-6
BF16_RTOL = 2.0 ** -7
STATS_TOL = 1e-6
ZERO_GRAD_TOL = {False: 1e-4, True: 0.1}  # of the net's largest moment
N_CRITIC_LOSS_ATOL = 5e-6


@pytest.fixture
def recorder():
    with recording() as rec:
        yield rec


# ---- Norm ---------------------------------------------------------------

def _maps(shape, seed):
    """Channels-last maps whose channels have their own offsets and
    scales, so each channel's statistics differ."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.standard_normal(shape) * rng.uniform(0.5, 3.0, c)
            + rng.uniform(-2.0, 2.0, c)).astype(np.float32)


def _channels_first(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _channels_last(t):
    return np.moveaxis(t.float().detach().numpy(), 1, -1)


def _pair(shape, layer_norm, bf16, seed=0):
    """Flax's ``Norm(batch_norm=True)`` variables (random affines and
    running statistics) and the port's ``Norm`` with them."""
    c = shape[-1]
    flax_norm = jax_base.Norm(batch_norm=True, layer_norm=layer_norm,
                              dtype=jnp.bfloat16 if bf16 else jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, flax_norm.init(
        jax.random.PRNGKey(0), jnp.zeros(shape), training=False))
    rng = np.random.default_rng(seed)
    for collection in variables.values():
        for norm in collection.values():
            for leaf, value in norm.items():
                centre = 1.0 if leaf in ("scale", "var") else 0.0
                norm[leaf] = (centre + 0.2 * rng.standard_normal(
                    value.shape)).astype(np.float32)
    port = base.Norm(c, batch_norm=True, layer_norm=layer_norm,
                     dtype=torch.bfloat16 if bf16 else torch.float32)
    sd = convert.generator_state_dict({"Norm_0": variables["params"]},
                                      batch_stats={"Norm_0": variables[
                                          "batch_stats"]})
    port.load_state_dict({k[len("norm.0."):]: v for k, v in sd.items()})
    return flax_norm, variables, port


def _stats(port):
    return (port.batch_norm.mean.numpy(), port.batch_norm.var.numpy())


SHAPES = pytest.mark.parametrize("shape", [(8, 64, 6), (4, 16, 6, 8),
                                           (4, 16, 6, 1)],
                                 ids=["NWC", "NHWC", "NHWC-1"])


@SHAPES
@pytest.mark.parametrize("layer_norm", [False, True])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_norm_matches_flax(shape, layer_norm, bf16):
    flax_norm, variables, port = _pair(shape, layer_norm, bf16)
    tol = dict(rtol=BF16_RTOL, atol=BF16_TOL) if bf16 else dict(
        rtol=0, atol=F32_TOL)
    apply_train = jax.jit(functools.partial(
        flax_norm.apply, training=True, mutable=["batch_stats"]))
    apply_eval = jax.jit(functools.partial(flax_norm.apply, training=False))
    for step in range(3):  # one update, then several
        x = _maps(shape, step)
        ref, mutated = apply_train(variables, jnp.asarray(x))
        variables = dict(variables, batch_stats=jax.tree_util.tree_map(
            np.asarray, mutated["batch_stats"]))
        out = port(_channels_first(x), True)
        np.testing.assert_allclose(_channels_last(out),
                                   np.asarray(ref, np.float32), **tol)
        stats = variables["batch_stats"]["BatchNorm_0"]
        for ours, theirs in zip(_stats(port), (stats["mean"], stats["var"])):
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=STATS_TOL)
        # evaluation reads the running statistics and moves nothing
        x = _maps(shape, 10 + step)
        before = [s.copy() for s in _stats(port)]
        with torch.no_grad():
            out = port(_channels_first(x))
        ref = apply_eval(variables, jnp.asarray(x))
        np.testing.assert_allclose(_channels_last(out),
                                   np.asarray(ref, np.float32), **tol)
        for a, b in zip(before, _stats(port)):
            np.testing.assert_array_equal(a, b)


def test_batch_norm_statistics_are_biased_float32_and_differentiable():
    """The batch variance is the biased ``E[x^2] - E[x]^2`` (not torch's
    unbiased running variance), the update weights the batch by 0.01, and
    gradients flow through the batch mean and variance: the normalised
    output's per-channel mean is 0 for any input, so a loss on that mean
    has a zero gradient only because the statistics are differentiated."""
    norm = base.Norm(3, batch_norm=True)
    x = torch.from_numpy(np.moveaxis(_maps((5, 7, 3), 0), -1, 1).copy())
    x.requires_grad_(True)
    y = norm(x, True)
    biased = x.detach().double().var((0, 2), unbiased=False)
    np.testing.assert_allclose(norm.batch_norm.var.double().numpy(),
                               0.99 + 0.01 * biased.numpy(), rtol=0,
                               atol=STATS_TOL)
    assert norm.batch_norm.mean.dtype == torch.float32
    y.mean((0, 2)).sum().backward()
    assert float(x.grad.abs().max()) < 1e-6
    assert sum(1 for _ in norm.parameters()) == 2  # scale, bias
    assert {n for n, _ in norm.named_buffers()} == {"batch_norm.mean",
                                                    "batch_norm.var"}


def test_param_count_matches_jax():
    """``named_parameters()`` counts what JAX's ``count_params(params)``
    counts: the running statistics are buffers."""
    for model, shape in (("calciumgan", (64, 6)),
                         ("calciumgan2d", (64, 6, 1))):
        sizes = dict(model=model, signal_shape=shape, num_neurons=6,
                     num_channels=shape[-1], sequence_length=64,
                     noise_dim=4, num_units=2, kernel_size=4,
                     batch_norm=True, layer_norm=True)
        gen, _ = get_models(Config(**sizes),
                            rng=torch.Generator().manual_seed(0))
        jgen, _ = jax_get_models(JaxConfig(**sizes))
        variables = jax.eval_shape(functools.partial(
            jgen.init, training=False), jax.random.PRNGKey(0),
            jnp.zeros((1, 4)))
        assert sum(p.numel() for p in gen.parameters()) == \
            jax_base.count_params(variables["params"])
        assert sum(b.numel() for b in gen.buffers()) == \
            jax_base.count_params(variables["batch_stats"])


# ---- the steps ------------------------------------------------------------

def _stats_after(new, model="calciumgan"):
    """The JAX step's generator running statistics as ``state_dict``
    entries."""
    return {k: v for k, v in convert.generator_state_dict(
        new.generator.params, model, new.generator.batch_stats).items()
        if k.endswith((".mean", ".var"))}


def _training_passes(module):
    """Counts the BatchNorm forwards of ``module`` that move statistics."""
    count = [0]

    def hook(_module, args, _out):
        count[0] += bool(args[1])

    for sub in module.modules():
        if isinstance(sub, base.BatchNorm):
            sub.register_forward_hook(hook)
            break  # one BatchNorm: one count a pass
    return count


def _run_step(rec, algorithm, bf16, edit=None, **kw):
    _, _, jalgo, jstate = make_pair(rec, algorithm=algorithm,
                                    mixed_precision=bf16, batch_norm=True,
                                    **kw)
    new, jlogs = jax.jit(jalgo.train_step)(
        jstate, jnp.asarray(real_batch()), jax.random.PRNGKey(1))
    new, jlogs = jax.tree_util.tree_map(np.asarray, (new, jlogs))
    draws = rec.take()
    draws = edit(draws) if edit else draws
    algo, state, _, _ = make_pair(rec, algorithm=algorithm,
                                  mixed_precision=bf16, batch_norm=True,
                                  **kw)
    passes = _training_passes(algo.generator)
    replay = Replay(draws)
    logs = algo.train_step(state, torch.from_numpy(real_batch()), replay)
    assert replay.left() == {}
    return new, jlogs, state, logs, passes[0]


def _check_stats(new, state):
    expected = _stats_after(new)
    buffers = dict(state.generator.module.named_buffers())
    assert set(buffers) == set(expected) and expected
    moved = 0.0
    for name, ref in expected.items():
        np.testing.assert_allclose(buffers[name].numpy(), ref.numpy(),
                                   rtol=0, atol=STATS_TOL, err_msg=name)
        start = 1.0 if name.endswith(".var") else 0.0
        moved = max(moved, float((ref - start).abs().max()))
    assert moved > 100 * STATS_TOL  # the updates are visible


def _once(draws):
    # the JAX GAN step traces its one forward under both gradients
    assert len(draws["noise"]) == 2 and len(draws["shift"]) == 8
    return {"noise": draws["noise"][:1], "shift": draws["shift"][:4]}


def _check_step(new, state, bf16):
    """``check_step`` on every parameter but the generator's ConvTranspose
    biases, whose gradient a BatchNorm removes: those are held to
    ``ZERO_GRAD_TOL`` of the net's largest moment, in both packages."""
    pairs = moments(new.generator, state.generator,
                    convert.generator_state_dict)
    scale = max(float(ref.abs().max()) for _, ref in pairs.values())
    zero = [n for n in pairs if n.startswith("conv_transpose.")
            and n.endswith(".bias")]
    for n in zero:
        ours, ref = pairs[n]
        assert max(float(ours.abs().max()), float(ref.abs().max())) \
            <= ZERO_GRAD_TOL[bf16] * scale, n
    check_step(new, state, bf16, skip=zero)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gan_step_with_batch_norm_matches_jax(recorder, bf16):
    new, jlogs, state, logs, passes = _run_step(recorder, "gan", bf16,
                                                edit=_once)
    assert passes == 1
    check_logs(jlogs, logs, bf16)
    _check_step(new, state, bf16)
    _check_stats(new, state)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wgan_gp_step_with_batch_norm_matches_jax(recorder, bf16):
    # n_critic 5: the running statistics move in 5 critic passes (under
    # no_grad in the port) and in the generator step
    new, jlogs, state, logs, passes = _run_step(recorder, "wgan-gp", bf16,
                                                n_critic=5)
    assert passes == 6
    loss = jlogs.pop("loss/generator")
    check_logs(jlogs, {k: v for k, v in logs.items()
                       if k != "loss/generator"}, bf16)
    np.testing.assert_allclose(
        float(logs["loss/generator"]), float(loss), rtol=LOSS_RTOL[bf16],
        atol=max(LOSS_ATOL[bf16], N_CRITIC_LOSS_ATOL))
    _check_step(new, state, bf16)
    _check_stats(new, state)


def test_evaluation_reads_running_statistics(recorder):
    """``eval_step`` and ``sample`` use the running statistics, the EMA's
    parameters beside the generator's buffers, and move nothing."""
    algo, state, _, _ = make_pair(recorder, algorithm="gan", batch_norm=True,
                                  ema=0.5)
    algo.train_step(state, torch.from_numpy(real_batch()),
                    Replay({"noise": [np.random.default_rng(0)
                                      .standard_normal((8, 8))
                                      .astype(np.float32)],
                            "shift": [0, 1, -1, 2]}))
    gen = algo.generator
    stats = {n: b.clone() for n, b in gen.named_buffers()}
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 8)).astype(np.float32))
    sampled = algo.sample(state, noise)
    for n, b in gen.named_buffers():
        torch.testing.assert_close(b, stats[n], rtol=0, atol=0)
    # the same by hand: EMA parameters loaded beside the running statistics
    twin, _ = get_models(algo.config)
    twin.load_state_dict({**gen.state_dict(), **state.ema})
    with torch.no_grad():
        torch.testing.assert_close(sampled, twin(noise), rtol=0, atol=0)
        fresh = {n: (torch.ones_like(b) if n.endswith("var")
                     else torch.zeros_like(b)) for n, b in stats.items()}
        twin.load_state_dict({**gen.state_dict(), **state.ema, **fresh})
        assert float((sampled - twin(noise)).abs().max()) > 1e-4


# ---- conversion ---------------------------------------------------------

def test_convert_batch_norm_round_trip_and_refusals():
    cfg = Config(signal_shape=(64, 6), num_channels=6, num_units=2,
                 kernel_size=4, noise_dim=4, batch_norm=True,
                 layer_norm=True)
    gen, _ = get_models(cfg, rng=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for b in gen.buffers():
            b.uniform_(0.5, 1.5)
    sd = gen.state_dict()
    variables = convert.flax_generator_variables(sd)
    assert set(variables["batch_stats"]["Norm_0"]) == {"BatchNorm_0"}
    assert set(variables["params"]["Norm_0"]) == {"BatchNorm_0",
                                                 "LayerNorm_0"}
    back = convert.generator_state_dict(variables["params"],
                                        batch_stats=variables["batch_stats"])
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    # a running mean is never filed as a parameter, nor dropped
    with pytest.raises(KeyError, match="flax_generator_variables"):
        convert.flax_generator_params(sd)
    with pytest.raises(KeyError, match="unexpected state_dict entry"):
        convert.flax_generator_variables({**sd, "norm.0.running": sd[
            "norm.0.batch_norm.mean"]})
    with pytest.raises(KeyError, match="unsupported norm"):
        convert.generator_state_dict(
            dict(variables["params"], Norm_0={"GroupNorm_0": {}}))
    with pytest.raises(KeyError, match="expected"):
        convert.generator_state_dict(
            variables["params"], batch_stats={
                "Norm_0": {"BatchNorm_0": {"mean": np.zeros(20)}}})
    with pytest.raises(KeyError, match="batch_stats group"):
        convert.generator_state_dict(variables["params"],
                                     batch_stats={"Dense_0": {}})
    with pytest.raises(KeyError, match="no conversion rules"):
        convert.flax_discriminator_params({}, "bogus")


# ---- checkpoints and generate ---------------------------------------------

def _flags(records, run, epochs, *extra):
    return ["--input_dir", records, "--output_dir", run, "--batch_size",
            "8", "--num_units", "2", "--kernel_size", "4", "--noise_dim",
            "4", "--epochs", str(epochs), "--n_critic", "2",
            "--batch_norm", "--layer_norm", "--learning_rate", "1e-2",
            "--ema", "0.5", "--verbose", "0", *extra]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn_records")
    rng = np.random.default_rng(1234)
    data = {"signals": rng.random((4, 800)).astype(np.float32),
            "oasis": (rng.random((4, 800)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, do_normalize=True, is_dg_data=True)
    out = str(tmp / "records")
    segments.write_dataset(out, signals, spikes, meta, 32, 8,
                           validation_size=16, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    return out


def test_pt_resume_keeps_running_statistics(records, tmp_path):
    run = str(tmp_path / "run")
    port_main.cli(_flags(records, run, 1, "--device", "cpu"))
    stored = torch.load(os.path.join(run, "checkpoints", "epoch-000.pt"),
                        weights_only=True)
    saved = {k: v for k, v in stored["generator"]["params"].items()
             if k.endswith((".mean", ".var"))}
    assert saved and all(k.startswith("norm.") for k in saved)
    assert max(float((v - float(k.endswith(".var"))).abs().max())
               for k, v in saved.items()) > 1e-3
    assert not any(k.endswith((".mean", ".var")) for k in stored["ema"])
    cfg = Config(output_dir=run, verbose=0).load()
    algo = get_algorithm(cfg, *get_models(cfg))
    state = algo.init_state()
    epoch, _ = checkpoint.restore(os.path.join(run, "checkpoints"), state,
                                  verbose=0)
    assert epoch == 0
    for name, buf in algo.generator.named_buffers():
        torch.testing.assert_close(buf, saved[name], rtol=0, atol=0)
    # generate serves the EMA with the stored statistics: GAN.sample
    variables, _ = checkpoint.restore_generator_params(
        os.path.join(run, "checkpoints"), ema=True)
    assert variables["batch_stats"]
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 4)).astype(np.float32))
    served = generate_mod.build_generator(cfg, variables, "cpu")
    with torch.no_grad():
        torch.testing.assert_close(served(noise), algo.sample(state, noise),
                                   rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_run(records, tmp_path_factory):
    """One JAX epoch with ``--batch_norm --ema``: its ``.msgpack`` holds
    ``generator.batch_stats``."""
    from main import parse_args
    run = str(tmp_path_factory.mktemp("bn_jax") / "run")
    cfg = parse_args(_flags(records, run, 1))
    jax_train.main(cfg)
    return run


def test_port_generate_on_a_jax_batch_norm_ema_run(jax_run):
    cfg = JaxConfig(output_dir=jax_run, verbose=0).load()
    algo = jax_algorithm(cfg, *jax_get_models(cfg))
    state, epoch = jax_checkpoint.restore(
        os.path.join(jax_run, "checkpoints"),
        algo.init_state(jax.random.PRNGKey(0)), verbose=0)
    assert epoch == 0 and state.ema_params is not None
    assert state.generator.batch_stats
    noise = np.random.default_rng(3).standard_normal(
        (12, cfg.noise_dim)).astype(np.float32)
    ref = jax_pipeline.reverse_preprocessing(
        cfg, np.asarray(algo.generate(state, jnp.asarray(noise))))

    port_cfg = Config(output_dir=jax_run, verbose=0).load()
    variables, restored = checkpoint.restore_generator_params(
        os.path.join(jax_run, "checkpoints"), ema=True)
    assert restored == 0 and variables["batch_stats"]
    generator = generate_mod.build_generator(port_cfg, variables, "cpu")
    with torch.no_grad():
        out = reverse_preprocessing(port_cfg, generator(
            torch.from_numpy(noise))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)
    # serving with the initial statistics (mean 0, var 1) is another output
    fresh = dict(variables, batch_stats=jax.tree_util.tree_map(
        lambda a: np.zeros_like(a), variables["batch_stats"]))
    for group in fresh["batch_stats"].values():
        group["BatchNorm_0"]["var"] = np.ones_like(
            group["BatchNorm_0"]["var"])
    generator = generate_mod.build_generator(port_cfg, fresh, "cpu")
    with torch.no_grad():
        stale = reverse_preprocessing(port_cfg, generator(
            torch.from_numpy(noise))).numpy()
    assert np.abs(stale - ref).max() > 100 * F32_TOL


def test_layer_table_counts_parameters_not_buffers():
    """``--verbose 2``'s table (``train.layer_table``): one row per module
    with parameters or buffers of its own, the running statistics marked
    as buffers and left out of the counts, the total ``count_params``."""
    from calciumgan_tpu_torch.train import count_params, layer_table
    cfg = Config(signal_shape=(64, 6), num_channels=6, num_units=2,
                 kernel_size=4, noise_dim=4, batch_norm=True,
                 layer_norm=True)
    gen, _ = get_models(cfg, rng=torch.Generator().manual_seed(0))
    table = layer_table(gen).splitlines()
    assert table[0] == "Generator"
    rows = {line.split()[0]: line for line in table[1:]}
    assert "mean (6,) (buffer)" in rows["norm.4.batch_norm"]
    assert rows["norm.4.batch_norm"].split()[2] == "12"  # scale and bias
    assert rows["total"].split()[1] == f"{count_params(gen):,}"
