"""The port's ``mlp`` model against the JAX package's: forward passes and
one full train step of each algorithm on the same weights, the same noise
and the same dropout masks.

The weights are the port's glorot draws, carried to Flax by
``calciumgan_tpu_torch.convert`` with the ``mlp`` rules. The JAX side's
masks are recorded by a stand-in for ``nn.Dropout`` of the same name, draw
and arithmetic (``torch_step_helpers.recording_dropout``) and replayed into
the port in execution order; one test holds that stand-in to Flax's own
``nn.Dropout`` bit for bit. Sizes: the surrogate set's sequences of 6
frames and 2 neurons, noise 8, units 4, dropout 0.2, batch 8.

Bounds:
- forward, float32: 1e-5 absolute (measured <= 2e-7); bfloat16: 1e-6 on
  the float32 outputs (measured 0: the port rounds where Flax does, and
  divides by the keep probability rounded to bfloat16 as Flax does);
- train steps: the bounds of ``test_torch_train_step.py`` (losses rtol
  1e-5 + atol 1e-6 in float32, 1e-4 + 1e-4 in bfloat16; Adam's first
  moments to 1e-4 of the tensor's largest in float32, 0.1 of the net's
  largest in bfloat16; the generator's updated float32 parameters to
  0.05 * lr).
Planted faults: dropout as a product by the reciprocal (bfloat16 forward),
the penalty pass reusing the critic pass's masks, a vanilla-GAN step that
draws fresh masks for its second gradient.
"""

import functools
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu.models import mlp as jax_mlp
from calciumgan_tpu.utils import checkpoint as jax_checkpoint
from calciumgan_tpu_torch import convert, generate
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.models import mlp
from calciumgan_tpu_torch.utils.checkpoint import restore_generator_params
from test_torch_train_step import (BF16_GRAD_TOL, F32_GRAD_TOL, LOSS_ATOL,
                                   LOSS_RTOL, check_logs, check_step,
                                   grad_errors, moments)
from torch_step_helpers import (Replay, make_pair, real_batch, recording,
                                tiny_mlp)

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 1e-6
SHAPE = (6, 2)
NETS = (("generator",
         functools.partial(convert.generator_state_dict, model="mlp")),
        ("discriminator",
         functools.partial(convert.discriminator_state_dict, model="mlp")))


@pytest.fixture(scope="module")
def recorder():
    with recording() as rec:
        yield rec


def _nets(bf16, **kw):
    """The port's two nets and the JAX modules with the same weights."""
    cfg = Config(**tiny_mlp(mixed_precision=bf16, **kw))
    gen, dis = get_models(cfg, rng=torch.Generator().manual_seed(3))
    jgen, jdis = jax_mlp.build(cfg)
    return (cfg, gen, dis, jgen, jdis,
            convert.flax_generator_params(gen.state_dict(), "mlp"),
            convert.flax_discriminator_params(dis.state_dict(), "mlp"))


def _jax_apply(rec, module, params, x, training):
    out = module.apply({"params": params}, jnp.asarray(x), training=training,
                       rngs={"dropout": jax.random.PRNGKey(5)})
    return np.asarray(out), rec.take()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_forward_matches_jax_on_the_same_masks(recorder, bf16):
    cfg, gen, dis, jgen, jdis, gparams, dparams = _nets(bf16)
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((8, cfg.noise_dim)).astype(np.float32)
    signals = rng.random((8,) + SHAPE).astype(np.float32)
    tol = BF16_TOL if bf16 else F32_TOL
    for net, jnet, params, x, widths in (
            (gen, jgen, gparams, noise, (4, 8, 12)),
            (dis, jdis, dparams, signals, (16, 12, 8, 4))):
        ref, draws = _jax_apply(recorder, jnet, params, x, True)
        assert [m.shape for m in draws["dropout"]] == [
            (8, 6, w) for w in widths]
        replay = Replay(draws)
        with torch.no_grad():
            out = net(torch.from_numpy(x),
                      *net.draw_inputs(replay, 8, True))
        assert replay.left() == {}
        assert out.dtype == torch.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
        # the masks matter: without them the output is another
        with torch.no_grad():
            plain = net(torch.from_numpy(x)).numpy()
        assert np.abs(plain - ref).max() > 100 * tol


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_evaluation_forward_draws_no_masks(recorder, bf16):
    cfg, gen, dis, jgen, jdis, gparams, dparams = _nets(bf16,
                                                        normalize=False)
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((5, cfg.noise_dim)).astype(np.float32)
    signals = rng.random((5,) + SHAPE).astype(np.float32)
    tol = BF16_TOL if bf16 else F32_TOL
    for net, jnet, params, x in ((gen, jgen, gparams, noise),
                                 (dis, jdis, dparams, signals)):
        ref, draws = _jax_apply(recorder, jnet, params, x, False)
        assert draws == {}
        assert net.draw_inputs(Replay({}), 5, False) == (None,)
        with torch.no_grad():
            out = net(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    assert gen(torch.from_numpy(noise)).shape == (5,) + SHAPE
    assert dis(torch.from_numpy(signals)).shape == (5, 1)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_recording_stand_in_equals_flax_dropout(recorder, monkeypatch, bf16):
    # the masks above are recorded by a stand-in for nn.Dropout: the JAX
    # modules as shipped, on Flax's own Dropout and the same dropout key
    # (so the same masks), give the same outputs bit for bit
    cfg, _, _, jgen, jdis, gparams, dparams = _nets(bf16)
    rng = np.random.default_rng(6)
    noise = rng.standard_normal((8, cfg.noise_dim)).astype(np.float32)
    signals = rng.random((8,) + SHAPE).astype(np.float32)
    for jnet, params, x, masks in ((jgen, gparams, noise, 3),
                                   (jdis, dparams, signals, 4)):
        stand_in, draws = _jax_apply(recorder, jnet, params, x, True)
        assert len(draws["dropout"]) == masks
        with monkeypatch.context() as shipped:
            shipped.setattr(jax_mlp, "nn", flax.linen)
            assert jax_mlp.nn.Dropout is flax.linen.Dropout
            ref, unrecorded = _jax_apply(recorder, jnet, params, x, True)
        assert unrecorded == {}
        np.testing.assert_array_equal(stand_in, ref)
        # and the masks matter there too
        off, _ = _jax_apply(recorder, jnet, params, x, False)
        assert np.abs(off - ref).max() > 100 * F32_TOL


def test_dropout_divides_by_the_rounded_keep_probability(recorder,
                                                          monkeypatch):
    x = torch.linspace(-3, 3, 4096).to(torch.bfloat16)
    keep = torch.ones(4096, dtype=torch.bool)
    keep[::3] = False
    ours = mlp.dropout(x, keep, 0.2)
    ref = jax.lax.select(jnp.asarray(keep.numpy()),
                         jnp.asarray(x.float().numpy(), jnp.bfloat16) / 0.8,
                         jnp.zeros(4096, jnp.bfloat16))
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert mlp.dropout(x, None, 1.0).abs().max() == 0
    _, gen0, _, _, _, _, _ = _nets(False, dropout=0.0)
    assert gen0.draw_inputs(Replay({}), 8, True) == (None,)  # rate 0: none
    # planted fault: a product by the reciprocal rounds otherwise in
    # bfloat16, and the forward bound catches it
    monkeypatch.setattr(mlp, "dropout", lambda x, keep, rate: torch.where(
        keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x)))
    cfg, gen, _, jgen, _, gparams, _ = _nets(True)
    noise = np.random.default_rng(1).standard_normal(
        (8, cfg.noise_dim)).astype(np.float32)
    ref, draws = _jax_apply(recorder, jgen, gparams, noise, True)
    with torch.no_grad():
        out = gen(torch.from_numpy(noise),
                  *gen.draw_inputs(Replay(draws), 8, True)).numpy()
    assert np.abs(out - ref).max() > 100 * BF16_TOL


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

_JAX_STEPS = {}


def jax_step(rec, algorithm, bf16):
    key = (algorithm, bf16)
    if key not in _JAX_STEPS:
        _, _, jalgo, jstate = make_pair(rec, model="mlp",
                                        algorithm=algorithm,
                                        mixed_precision=bf16)
        new, logs = jax.jit(jalgo.train_step)(
            jstate, jnp.asarray(real_batch(shape=SHAPE)),
            jax.random.PRNGKey(1))
        host = jax.tree_util.tree_map(np.asarray, (new, logs))
        _JAX_STEPS[key] = (*host, rec.take())
    return _JAX_STEPS[key]


def run_train_step(rec, algorithm, bf16, edit=None):
    new, jlogs, draws = jax_step(rec, algorithm, bf16)
    algo, state, _, _ = make_pair(rec, model="mlp", algorithm=algorithm,
                                  mixed_precision=bf16)
    replay = Replay(edit(draws) if edit else draws)
    logs = algo.train_step(state, torch.from_numpy(real_batch(shape=SHAPE)),
                           replay)
    assert replay.left() == {}
    return new, jlogs, state, logs, draws


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wgan_gp_step_matches_jax(recorder, bf16):
    new, jlogs, tstate, tlogs, draws = run_train_step(recorder, "wgan-gp",
                                                      bf16)
    # per critic step: the generator's 3 masks, the critic's 4 over
    # concat(real, fake), the penalty's 4; then the generator step's 3 + 4
    assert {k: len(v) for k, v in draws.items()} == {
        "noise": 3, "alpha": 2, "dropout": 2 * 11 + 7}
    assert [m.shape[0] for m in draws["dropout"][:11]] == \
        [8] * 3 + [16] * 4 + [8] * 4
    check_logs(jlogs, tlogs, bf16)
    check_step(new, tstate, bf16, NETS)


def _once(draws):
    # one forward traced under both gradients: each draw twice, equal
    assert len(draws["noise"]) == 2 and len(draws["dropout"]) == 14
    np.testing.assert_array_equal(draws["noise"][0], draws["noise"][1])
    for a, b in zip(draws["dropout"][:7], draws["dropout"][7:]):
        np.testing.assert_array_equal(a, b)
    return {"noise": draws["noise"][:1], "dropout": draws["dropout"][:7]}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gan_step_matches_jax(recorder, bf16):
    new, jlogs, tstate, tlogs, _ = run_train_step(recorder, "gan", bf16,
                                                  edit=_once)
    check_logs(jlogs, tlogs, bf16)
    check_step(new, tstate, bf16, NETS)


def _gp_reuses_critic_masks(draws):
    masks = list(draws["dropout"])
    for start in (0, 11):  # 3 generator, 4 critic (16 rows), 4 GP (8 rows)
        masks[start + 7:start + 11] = [m[:8] for m in
                                       masks[start + 3:start + 7]]
    return dict(draws, dropout=masks)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_bounds_fail_when_the_penalty_shares_the_critic_masks(recorder,
                                                              bf16):
    new, jlogs, tstate, tlogs, _ = run_train_step(
        recorder, "wgan-gp", bf16, edit=_gp_reuses_critic_masks)
    pairs = moments(new.discriminator, tstate.discriminator, NETS[1][1])
    tol = BF16_GRAD_TOL if bf16 else F32_GRAD_TOL
    assert grad_errors(pairs, bf16) > 2 * tol
    gp, ref = float(tlogs["loss/gradient_penalty"]), float(
        jlogs["loss/gradient_penalty"])
    assert abs(gp - ref) > 10 * (LOSS_RTOL[bf16] * abs(ref) + LOSS_ATOL[bf16])


def test_gan_gradients_share_one_forward(recorder):
    # the port's vanilla step takes exactly one set of masks (7), as the
    # JAX step's one forward does; a second set is left over
    _, _, draws = jax_step(recorder, "gan", False)
    algo, state, _, _ = make_pair(recorder, model="mlp", algorithm="gan")
    replay = Replay({"noise": draws["noise"], "dropout": draws["dropout"]})
    algo.train_step(state, torch.from_numpy(real_batch(shape=SHAPE)), replay)
    assert replay.left() == {"noise": 1, "dropout": 7}


def test_eval_step_and_sample_run_without_dropout(recorder):
    for algorithm in ("gan", "wgan-gp"):
        algo, state, _, _ = make_pair(recorder, model="mlp",
                                      algorithm=algorithm)
        noise = np.random.default_rng(4).standard_normal((8, 8)).astype(
            np.float32)
        alpha = np.full((8,), 0.5, np.float32)
        replay = Replay({"noise": [noise], "alpha": [alpha]})  # no masks
        fake, logs = algo.eval_step(
            state, torch.from_numpy(real_batch(shape=SHAPE)), replay)
        assert replay.left() == ({"alpha": 1} if algorithm == "gan" else {})
        torch.testing.assert_close(
            fake, algo.sample(state, torch.from_numpy(noise)), rtol=0, atol=0)
        assert all(np.isfinite(float(v)) for v in logs.values())


# ---------------------------------------------------------------------------
# convert, checkpoints, serving
# ---------------------------------------------------------------------------

def test_convert_round_trip_both_ways():
    cfg, gen, dis, jgen, jdis, gparams, dparams = _nets(False)
    assert sorted(gparams) == sorted(dparams) == [
        f"Dense_{i}" for i in range(5)]
    # kernels transposed: Flax (in, out), the port (out, in)
    assert gparams["Dense_0"]["kernel"].shape == (8, 6 * 8)
    assert dparams["Dense_4"]["kernel"].shape == (6 * 4, 1)
    for net, params, to_sd in ((gen, gparams, NETS[0][1]),
                               (dis, dparams, NETS[1][1])):
        back = to_sd(params)
        assert list(back) == list(net.state_dict())
        for k, v in net.state_dict().items():
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    # Flax-initialised params load into the port's nets and come back
    variables = jgen.init({"params": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)},
                          jnp.zeros((1, cfg.noise_dim)), training=False)
    flax_params = jax.tree_util.tree_map(np.asarray, variables["params"])
    gen.load_state_dict(NETS[0][1](flax_params))
    again = convert.flax_generator_params(gen.state_dict(), "mlp")
    for group, leaves in flax_params.items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(again[group][leaf], value)
    with pytest.raises(KeyError, match="unexpected mlp parameter group"):
        convert.generator_state_dict({"Conv_0": {}}, "mlp")


def test_generate_serves_a_jax_mlp_checkpoint(recorder, tmp_path):
    _, _, jalgo, jstate = make_pair(recorder, model="mlp", algorithm="gan")
    ckpt = str(tmp_path / "checkpoints")
    jax_checkpoint.save(ckpt, 3, jstate, verbose=0)
    assert os.path.exists(os.path.join(ckpt, "epoch-003.msgpack"))
    params, epoch = restore_generator_params(ckpt, ema=False, model="mlp")
    assert epoch == 3
    cfg = Config(**tiny_mlp())
    payload = next(generate.generate(cfg, params, 16, 16, seed=2,
                                     device="cpu"))
    noise = torch.randn((16, cfg.noise_dim),
                        generator=torch.Generator().manual_seed(2))
    ref = np.asarray(jalgo.generate(jstate, jnp.asarray(noise.numpy())))
    assert payload["signals"].shape == (16,) + SHAPE
    np.testing.assert_allclose(payload["signals"], ref, rtol=0, atol=F32_TOL)
