"""The port's phase shuffle, strided SAME convolution and Discriminator
against the JAX package's, with Flax-initialised weights carried over by
``calciumgan_tpu_torch.convert``.

The JAX discriminator's shifts are recorded by a test-side stand-in for
``calciumgan_tpu.models.calciumgan.phase_shuffle`` that draws exactly as the
original and reports each shift through ``jax.debug.callback(ordered=True)``
(Flax ``init`` draws 4, which are dropped); the port's forward takes them
in the same order.

Bounds on the critic's output (about 0.1 in size): float32 atol 1e-6
(measured <= 3e-8: the convolutions sum in another order); bfloat16 atol
1e-6 (measured 0: the port rounds where Flax does). Each bound fails on a
deliberate fault: a channel-major flatten, the SAME padding's halves
swapped (kernel 5, stride 2), a shift off by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from calciumgan_tpu.models import calciumgan as jax_calciumgan
from calciumgan_tpu.ops.phase_shuffle import _shift_axis as jax_shift_axis
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import base, get_models
from calciumgan_tpu_torch.models.calciumgan import Discriminator
from calciumgan_tpu_torch.ops import phase_shuffle as port_shuffle
from torch_step_helpers import recording

torch.set_num_threads(1)

TOL = 1e-6

CASES = [  # (kernel_size, sequence_length)
    (4, 64),    # K - s even: symmetric SAME padding
    (5, 64),    # K - s odd: one more frame on the right
    (24, 128),  # the flagship kernel
]


@pytest.mark.parametrize("width", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("m", [1, 2, 3, 10])
def test_shift_axis_matches_jax_for_every_shift(width, m):
    x = np.random.default_rng(width * 31 + m).standard_normal(
        (2, width, 3)).astype(np.float32)
    for shift in range(-m, m + 1):
        ref = np.asarray(jax_shift_axis(jnp.asarray(x), jnp.asarray(shift),
                                        m, 1))
        ours = port_shuffle._shift_axis(torch.from_numpy(x), shift, m, 1)
        np.testing.assert_array_equal(ours.numpy(), ref)
        # NCW, time last: the discriminator's layout
        ncw = port_shuffle.phase_shuffle(
            torch.from_numpy(x).transpose(1, 2), shift, m, axis=-1)
        np.testing.assert_array_equal(ncw.transpose(1, 2).numpy(), ref)


def test_draw_shifts_cover_the_range():
    gen = torch.Generator().manual_seed(0)
    shifts = port_shuffle.draw_shifts(gen, 3, 400)
    assert len(shifts) == 400 and set(shifts) == set(range(-3, 4))
    assert port_shuffle.draw_shifts(gen, 0, 4) == []
    x = torch.randn(2, 3, 8)
    assert port_shuffle.phase_shuffle(x, 5, 0) is x


@pytest.mark.parametrize("kernel_size", [1, 4, 5, 24])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("width", [1, 7, 64])
def test_same_conv_padding_equals_xla(kernel_size, stride, width):
    pads = lax.padtype_to_pads((width,), (kernel_size,), (stride,), "SAME")
    assert base.same_conv_padding(width, kernel_size, stride) == tuple(
        pads[0])


def flax_pair(rec, kernel_size, sequence_length, m, bf16, seed=0):
    """A Flax discriminator's variables and the port's with its weights."""
    flax_dis = jax_calciumgan.Discriminator(
        num_units=3, kernel_size=kernel_size, strides=2, m=m,
        dtype=jnp.bfloat16 if bf16 else jnp.float32)
    x = jnp.zeros((1, sequence_length, 6))
    variables = flax_dis.init({"params": jax.random.PRNGKey(seed),
                               "phase": jax.random.PRNGKey(seed + 1)}, x)
    rec.take()  # init's draws
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port = Discriminator(sequence_length, 6, num_units=3,
                         kernel_size=kernel_size, strides=2, m=m,
                         dtype=torch.bfloat16 if bf16 else torch.float32,
                         rng=torch.Generator().manual_seed(seed))
    port.load_state_dict(convert.discriminator_state_dict(params))
    return flax_dis, variables, port


def run_both(rec, flax_dis, variables, port, x, key=2):
    ref = np.asarray(jax.jit(flax_dis.apply)(
        variables, jnp.asarray(x), rngs={"phase": jax.random.PRNGKey(key)}))
    shifts = [int(s) for s in rec.take().get("shift", [])]
    with torch.no_grad():
        out = port(torch.from_numpy(x), shifts).numpy()
    return ref, out, shifts


@pytest.fixture(scope="module")
def recorder():
    with recording() as rec:
        yield rec


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [0, 10])  # m 2: the fault tests
@pytest.mark.parametrize("kernel_size,sequence_length", CASES)
def test_discriminator_matches_flax(recorder, bf16, m, kernel_size,
                                    sequence_length):
    flax_dis, variables, port = flax_pair(recorder, kernel_size,
                                          sequence_length, m, bf16)
    x = np.random.default_rng(1).random((5, sequence_length, 6)).astype(
        np.float32)
    ref, out, shifts = run_both(recorder, flax_dis, variables, port, x)
    assert len(shifts) == (4 if m else 0)
    assert out.shape == ref.shape == (5, 1) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_bound_fails_on_a_channel_major_flatten(recorder):
    flax_dis, variables, port = flax_pair(recorder, 5, 64, 2, False)
    x = np.random.default_rng(1).random((5, 64, 6)).astype(np.float32)
    # the Dense weights a channel-major flatten of the (W', C') map reads
    w = port.dense.weight.detach().reshape(1, 2, 15)
    with torch.no_grad():
        port.dense.weight.copy_(w.transpose(1, 2).reshape(1, -1))
    ref, out, _ = run_both(recorder, flax_dis, variables, port, x)
    assert np.abs(out - ref).max() > 100 * TOL


def test_bound_fails_on_swapped_same_padding(recorder, monkeypatch):
    flax_dis, variables, port = flax_pair(recorder, 5, 64, 2, False)
    x = np.random.default_rng(1).random((5, 64, 6)).astype(np.float32)
    same = base.same_conv_padding
    monkeypatch.setattr(base, "same_conv_padding",
                        lambda w, k, s: same(w, k, s)[::-1])
    ref, out, _ = run_both(recorder, flax_dis, variables, port, x)
    assert np.abs(out - ref).max() > 100 * TOL


def test_bound_fails_on_a_shift_off_by_one(recorder):
    flax_dis, variables, port = flax_pair(recorder, 4, 64, 2, False)
    x = np.random.default_rng(1).random((5, 64, 6)).astype(np.float32)
    ref, _, shifts = run_both(recorder, flax_dis, variables, port, x)
    shifts[0] += 1 if shifts[0] < 2 else -1
    with torch.no_grad():
        out = port(torch.from_numpy(x), shifts).numpy()
    assert np.abs(out - ref).max() > 100 * TOL


def test_convert_round_trip_and_layout(recorder):
    _, variables, port = flax_pair(recorder, 5, 64, 2, False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    sd = convert.discriminator_state_dict(params)
    assert set(sd) == set(port.state_dict())
    assert sd["conv.0.weight"].shape == (3, 6, 5)  # (Cout, Cin, K)
    assert sd["dense.weight"].shape == (1, 2 * 15)
    back = convert.flax_discriminator_params(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_registry_builds_generator_and_discriminator():
    cfg = Config(signal_shape=(64, 6), num_channels=6, num_units=4,
                 kernel_size=5, noise_dim=4, m=3, mixed_precision=True)
    gen, dis = get_models(cfg, rng=torch.Generator().manual_seed(0))
    assert gen.dtype == dis.dtype == torch.bfloat16
    assert dis.num_shifts == 4 and dis.m == 3
    assert dis.dense.weight.shape == (1, 2 * 20)
    assert float(dis.dense.bias.detach().abs().max()) == 0.0
    conv = dis.conv[1].weight  # (Cout=8, Cin=4, K=5)
    limit = np.sqrt(6.0 / (5 * 4 + 5 * 8))  # fans count K*Cin, K*Cout
    assert float(conv.detach().abs().max()) <= limit
    with pytest.raises(ValueError, match="4 phase shifts"):
        dis(torch.zeros(1, 64, 6), [0, 0])
