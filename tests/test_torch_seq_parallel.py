"""The port's sequence-parallel critic and generator
(``calciumgan_tpu_torch.parallel.seq_parallel``) in 2 and 4 gloo ranks
against the Flax modules and JAX's unsharded functions
(``tests/test_seq_parallel.py``), the weights from Flax's ``init``:

- the halo phase shuffle equals JAX's shift of the whole sequence bit for
  bit, at every shift of ``-m..m`` tried, and its input gradient (the
  reflect exchange's adjoint) the unsharded shuffle's;
- the critic at m 0 against ``Discriminator.apply`` (atol 2e-5), and at
  m 10 against JAX's forward of the whole sequence with the same shift at
  each layer (atol 2e-4, rtol 2e-5);
- the generator, with and without LayerNorm, against
  ``Generator.apply`` (atol 3e-5);
- the WGAN-GP critic loss, gradient penalty included, differentiated
  through the halo exchange (the penalty's second derivative through the
  exchange's adjoint) against JAX's unsharded ``value_and_grad``: loss
  rtol 1e-5, each parameter's gradient atol 5e-5 and rtol 1e-4
  (``tests/test_seq_parallel.py:160-197``). A gradient scaled by the
  number of ranks fails it.

All rank work runs in one launch of 2 ranks and one of 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from calciumgan_tpu.models import base as jax_base
from calciumgan_tpu.models.calciumgan import Discriminator, Generator
from calciumgan_tpu.ops.phase_shuffle import _shift_axis as jax_shift_axis
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.ops.phase_shuffle import phase_shuffle
from calciumgan_tpu_torch.parallel import launch as launch_lib
import torch_rank_helpers as ranks

torch.set_num_threads(1)

TIMEOUT = 300
WORLDS = (2, 4)
SHIFTS = (-10, -7, -1, 0, 3, 10)
M = 10
W, C, U, K, S = 1024, 3, 2, 24, 2   # 1024 / 4 / 16 = 16 >= the halo of 11
GRAD_W = 2048


def _sizes(m, W=W, noise_dim=8, layer_norm=True):
    return dict(model="calciumgan", algorithm="wgan-gp", sequence_length=W,
                num_neurons=C, num_channels=C, signal_shape=(W, C),
                noise_dim=noise_dim, num_units=U, kernel_size=K, strides=S,
                m=m, layer_norm=layer_norm, normalize=True,
                signals_min=0.0, signals_max=1.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _discriminator(m, W=W):
    x = np.random.default_rng(W + m).standard_normal((2, W, C)).astype(
        np.float32)
    dis = Discriminator(num_units=U, kernel_size=K, strides=S, m=m)
    params = _np(dis.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          training=False)["params"])
    return dis, params, x


def _generator(layer_norm):
    gen = Generator(sequence_length=W, num_channels=C, noise_dim=8,
                    num_units=U, kernel_size=K, strides=S,
                    layer_norm=layer_norm)
    z = np.random.default_rng(int(layer_norm)).standard_normal(
        (2, 8)).astype(np.float32)
    variables = gen.init(jax.random.PRNGKey(0), jnp.asarray(z),
                         training=False)
    return gen, _np(variables["params"]), z


def _shuffle_input():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2, 3, 512)).astype(np.float32),
            rng.standard_normal((2, 3, 512)).astype(np.float32))


def _critic_inputs():
    rng = np.random.default_rng(11)
    _, params, _ = _discriminator(0, GRAD_W)
    real = rng.standard_normal((2, GRAD_W, C)).astype(np.float32)
    fake = rng.standard_normal((2, GRAD_W, C)).astype(np.float32)
    alpha = rng.random((2, 1, 1)).astype(np.float32)
    return params, real, fake, alpha


@pytest.fixture(scope="module")
def rank_results():
    jobs = []
    x, cot = _shuffle_input()
    for shift in SHIFTS:
        jobs.append((("shuffle", shift), ranks.rank_phase_shuffle,
                     (x, shift, M, cot)))
    for m, shifts in ((0, None), (M, [7, -10, 3, 10])):
        _, params, x = _discriminator(m)
        jobs.append((("dis", m), ranks.rank_seq_discriminator,
                     (_sizes(m), convert.discriminator_state_dict(params),
                      x, shifts)))
    for layer_norm in (True, False):
        _, params, z = _generator(layer_norm)
        jobs.append((("gen", layer_norm), ranks.rank_seq_generator,
                     (_sizes(0, layer_norm=layer_norm),
                      convert.generator_state_dict(params), z)))
    params, real, fake, alpha = _critic_inputs()
    jobs.append(("critic", ranks.rank_critic_loss,
                 (_sizes(0, GRAD_W), convert.discriminator_state_dict(params),
                  real, fake, alpha)))
    return {world: launch_lib.launch(ranks.rank_jobs, ["cpu"] * world,
                                     "gloo", args=(jobs,),
                                     timeout=TIMEOUT)
            for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("shift", SHIFTS)
def test_halo_phase_shuffle_matches_unsharded(rank_results, world, shift):
    x, cot = _shuffle_input()
    want = np.asarray(jax_shift_axis(jnp.asarray(x), jnp.int32(shift), M,
                                     2))
    whole = torch.from_numpy(x).requires_grad_(True)
    (phase_shuffle(whole, shift, M) * torch.from_numpy(cot)).sum().backward()
    for res in rank_results[world]:
        got = res[("shuffle", shift)]
        np.testing.assert_array_equal(got["out"], want)
        np.testing.assert_array_equal(got["x_grad"], whole.grad.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_discriminator_matches_flax_at_m0(rank_results, world):
    dis, params, x = _discriminator(0)
    want = np.asarray(dis.apply({"params": params}, jnp.asarray(x),
                                training=False))
    for res in rank_results[world]:
        np.testing.assert_allclose(res[("dis", 0)], want, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_discriminator_matches_whole_sequence_forward_with_phase_shuffle(
        rank_results, world):
    _, params, x = _discriminator(M)
    act = jax_base.activation("leakyrelu")
    h = jnp.asarray(x)
    for i, shift in enumerate([7, -10, 3, 10, None]):
        layer = params[f"Conv_{i}"]
        h = act(lax.conv_general_dilated(
            h, layer["kernel"], window_strides=(S,), padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC")) + layer["bias"])
        if shift is not None:
            h = jax_shift_axis(h, jnp.int32(shift), M, 1)
    want = np.asarray(h.reshape(h.shape[0], -1) @ params["Dense_0"]["kernel"]
                      + params["Dense_0"]["bias"])
    for res in rank_results[world]:
        np.testing.assert_allclose(res[("dis", M)], want, atol=2e-4,
                                   rtol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layer_norm", [True, False])
def test_generator_matches_flax(rank_results, world, layer_norm):
    gen, params, z = _generator(layer_norm)
    want = np.asarray(gen.apply({"params": params}, jnp.asarray(z),
                                training=False))
    for res in rank_results[world]:
        got = res[("gen", layer_norm)]
        assert got.shape == want.shape == (2, W, C)
        np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_wgan_gp_gradients_match_through_the_exchange(rank_results, world):
    params, real, fake, alpha = _critic_inputs()
    dis = Discriminator(num_units=U, kernel_size=K, strides=S, m=0)

    def loss(p, real, fake):
        apply = lambda x: dis.apply({"params": p}, x, training=False)  # noqa
        x_hat = alpha * real + (1 - alpha) * fake
        g = jax.grad(lambda x: jnp.sum(apply(x)))(x_hat)
        norm = jnp.sqrt(jnp.sum(g.reshape(g.shape[0], -1) ** 2, 1) + 1e-12)
        gp = jnp.mean((norm - 1.0) ** 2)
        return -jnp.mean(apply(real)) + jnp.mean(apply(fake)) + 10.0 * gp

    l0, g0 = jax.value_and_grad(loss)(params, jnp.asarray(real),
                                      jnp.asarray(fake))
    want = convert.discriminator_state_dict(_np(g0))
    for res in rank_results[world]:
        got = res["critic"]
        np.testing.assert_allclose(got["loss"], float(l0), rtol=1e-5)
        assert set(got["grads"]) == set(want)
        for name, ref in want.items():
            np.testing.assert_allclose(got["grads"][name], ref.numpy(),
                                       atol=5e-5, rtol=1e-4, err_msg=name)


def test_shards_narrower_than_the_halo_are_refused():
    from calciumgan_tpu_torch.parallel import halo_conv
    with pytest.raises(ValueError, match="smaller than halo"):
        halo_conv.exchange_halos(torch.zeros(1, 2, 8), 11, 11, None)
    from calciumgan_tpu_torch.parallel import seq_parallel
    with pytest.raises(ValueError, match="must exceed m=10"):
        seq_parallel.halo_phase_shuffle_local(torch.zeros(1, 2, 10), 3, 10,
                                              None)
