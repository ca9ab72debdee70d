"""The port's eval steps, signal metrics and generator EMA against the JAX
package (the train steps are in ``test_torch_train_step.py``, whose
helpers this file shares).

Bounds: losses, GP and metrics float32 rtol 1e-5 with atol 1e-6 (the eval
step updates nothing, so no Adam sign flip perturbs them; measured <=
2e-7); fake signals atol 1e-5, the generator bound of
``test_torch_models.py``. The unbiased standard deviation falls outside the
metrics bound by over 100x.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu.ops import signal_metrics as jax_metrics
from calciumgan_tpu_torch.algorithms import get_algorithm
from calciumgan_tpu_torch.algorithms.gan import Draws
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.ops import signal_metrics
from torch_step_helpers import Replay, make_pair, real_batch, recording, tiny

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def recorder():
    with recording() as rec:
        yield rec


@pytest.mark.parametrize("algorithm", ["wgan-gp", "gan"])
@pytest.mark.parametrize("masked", [True, False], ids=["tail", "full"])
def test_eval_step_matches_jax(recorder, algorithm, masked):
    algo, state, jalgo, jstate = make_pair(recorder, algorithm=algorithm,
                                           kernel_size=5)
    real = real_batch(seed=3)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32) if masked else None
    jfake, jlogs = jax.jit(jalgo.eval_step)(
        jstate, jnp.asarray(real), jax.random.PRNGKey(2),
        None if mask is None else jnp.asarray(mask))
    draws = recorder.take()
    if algorithm == "wgan-gp":  # real pass, fake pass, GP pass
        assert len(draws["shift"]) == 12 and len(draws["alpha"]) == 1
    replay = Replay(draws)
    fake, logs = algo.eval_step(
        state, torch.from_numpy(real), replay,
        None if mask is None else torch.from_numpy(mask))
    assert replay.left() == {}
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfake), rtol=0,
                               atol=1e-5)
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(logs["batch/real_rows"]) == (5.0 if masked else 8.0)


@pytest.mark.parametrize("masked", [True, False], ids=["tail", "full"])
def test_signal_metrics_match_jax(masked):
    rng = np.random.default_rng(4)
    real = rng.random((6, 32, 5)).astype(np.float32)
    fake = rng.random((6, 32, 5)).astype(np.float32)
    mask = np.array([1, 1, 1, 0, 0, 0], np.float32) if masked else None
    ref = jax_metrics.all_signal_metrics(
        jnp.asarray(real), jnp.asarray(fake),
        None if mask is None else jnp.asarray(mask))
    ours = signal_metrics.all_signal_metrics(
        torch.from_numpy(real), torch.from_numpy(fake),
        None if mask is None else torch.from_numpy(mask))
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # an unbiased std falls outside the bound
    unbiased = signal_metrics.batch_weighted_mean(
        (torch.from_numpy(real).std(-1) - torch.from_numpy(fake).std(-1))
        .square(), None if mask is None else torch.from_numpy(mask))
    ref_std = float(ref["signals_metrics/std"])
    assert abs(float(unbiased) - ref_std) > 100 * (RTOL * ref_std + ATOL)


def test_ema_is_a_pure_sidecar():
    # trajectories that differ only in --ema (off / 0.5 / 0.99) leave
    # bit-identical nets and optimizer states, and the EMA follows
    # ema = d * ema + (1 - d) * params
    finals = {}
    real = torch.from_numpy(real_batch())
    for ema in (0.0, 0.5, 0.99):
        cfg = Config(**tiny(ema=ema, n_critic=1))
        algo = get_algorithm(cfg, *get_models(cfg))
        state = algo.init_state()
        assert (state.ema is None) == (ema == 0.0)
        for i in range(3):
            before = None if state.ema is None else {
                k: v.clone() for k, v in state.ema.items()}
            algo.train_step(state, real, Draws(cfg.seed, i, "cpu"))
            if before is not None:
                for n, p in algo.generator.named_parameters():
                    torch.testing.assert_close(
                        state.ema[n], ema * before[n] + (1 - ema) * p,
                        rtol=1e-6, atol=1e-9)
        finals[ema] = state
    base = finals[0.0]
    for ema in (0.5, 0.99):
        for name in ("generator", "discriminator"):
            a, b = getattr(base, name), getattr(finals[ema], name)
            torch.testing.assert_close(a.module.state_dict(),
                                       b.module.state_dict(), rtol=0, atol=0)
            for pa, pb in zip(a.module.parameters(), b.module.parameters()):
                torch.testing.assert_close(a.optimizer.state[pa],
                                           b.optimizer.state[pb], rtol=0,
                                           atol=0)
        # the EMA drives sampling, the raw generator does not
        noise = torch.zeros(4, 8)
        algo_ema = get_algorithm(Config(**tiny(ema=ema)),
                                 finals[ema].generator.module,
                                 finals[ema].discriminator.module)
        raw = algo_ema.sample(dataclasses.replace(finals[ema], ema=None),
                              noise)
        assert float((algo_ema.sample(finals[ema], noise) - raw).abs().max()
                     ) > 0


def test_n_critic_and_ema_validation():
    with pytest.raises(ValueError, match="n_critic"):
        cfg = Config(**tiny(n_critic=0))
        get_algorithm(cfg, *get_models(cfg))
    with pytest.raises(ValueError, match="--ema"):
        cfg = Config(**tiny(ema=1.0))
        get_algorithm(cfg, *get_models(cfg))


def test_draws_replay_from_seed_and_counter():
    a, b, c = (Draws(7, 3, "cpu"), Draws(7, 3, "cpu"), Draws(7, 4, "cpu"))
    for d in (a, b, c):
        d.values = (d.noise(4, 8), d.alpha(4), d.shifts(10, 4))
    torch.testing.assert_close(a.values[:2], b.values[:2], rtol=0, atol=0)
    assert a.values[2] == b.values[2]
    assert all(-10 <= s <= 10 for s in a.values[2])
    assert not torch.equal(a.values[0], c.values[0])
    assert Draws(7, 3, "cpu").shifts(0, 4) == []
