"""The port's ``calciumgan2d`` model against the JAX package's: the 2-D
SAME convolutions, the 2-D phase shuffle, ``Generator2D`` and
``Discriminator2D`` forward, one full WGAN-GP step and the weight
conversion, at the sizes of ``tests/test_models.py:49-90`` (64 frames, 6
neurons, 1 channel, units 2, kernel 4, noise 4).

Weights: Flax ``init`` draws carried to the port by
``calciumgan_tpu_torch.convert`` (forward tests), or the port's glorot draws
carried to a JAX state (the step). Phase shifts are recorded in a test-side
stand-in for ``calciumgan_tpu.models.calciumgan2d.phase_shuffle_2d`` that
draws as the original does (time, then neurons) and replayed into the
port's ``draw_inputs``.

Bounds:
- float32 forward: 1e-5 absolute, the 1-D generator's bound
  (``test_torch_models.py``): the convolutions sum in another order and
  LayerNorm scales such differences by up to ``1/sqrt(var + 1e-3)``. The
  float32 cases run at units 4 with one output channel under LayerNorm: a
  LayerNorm over 2 channels (units 2's layer 3, or the output of a 2-channel
  set) is about ``sign(a - b)``, so a reordering of 1e-7 comes out as up to
  2e-4 (measured); those sets are held in bfloat16 below;
- bfloat16 forward: 1e-6 absolute (measured 0 to 3e-8): both packages
  round each layer to bfloat16 at the same points. It is held to what it
  must catch: the port's float32 nets on the same weights fall outside it
  (``test_bf16_bound_rejects_float32``);
- the step: the 1-D step's bounds (``test_torch_train_step.py``).

The critic's 16 x 16 kernels mostly read zero padding on 64 x 6 maps, so
its inputs are drawn in [0, 100) to give outputs of about 0.02.

The bfloat16 critics run at units 16: PyTorch 2.13's CPU build, through
oneDNN, returned wrong bfloat16 ``conv2d`` sums for 16 x 16 kernels over an
even number of input channels from 4 to 14 on an Intel Xeon (relative
error about 1; units 2 gives the critic's layers 1-4 4, 6 and 8 channels),
and right ones (within the bfloat16 rounding, 2e-3) at 1-3 and 16-79
channels. PyTorch's own CPU convolution, the alternative, rounds other
convolutions otherwise than XLA.
"""

import functools
import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu.models import calciumgan2d as jax_2d
from calciumgan_tpu.ops.phase_shuffle import _shift_axis as jax_shift_axis
from calciumgan_tpu.ops.phase_shuffle import phase_shuffle_2d as jax_ps2d
from calciumgan_tpu_torch import compute_metrics, convert
from calciumgan_tpu_torch import generate as generate_mod
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.dataset import generate_tfrecords
from calciumgan_tpu_torch.models import base, get_models
from calciumgan_tpu_torch.models.calciumgan2d import (Discriminator2D,
                                                      Generator2D)
from calciumgan_tpu_torch.ops import phase_shuffle as port_shuffle
from calciumgan_tpu_torch.utils import h5, io
from test_torch_train_step import check_logs, check_step, grad_errors, moments
from torch_step_helpers import (Replay, jax_calciumgan2d, make_pair,
                                real_batch, recording, tiny_2d)

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 1e-6
T, N = 64, 6
CRITIC_INPUT_SCALE = 100.0


@pytest.fixture(scope="module")
def recorder():
    with recording() as rec:
        yield rec

BF16_CRITIC_UNITS = 16
BF16_STEP_GAP = 2.0


# ---- the 2-D SAME convolutions --------------------------------------------

CONV_CASES = [  # (kernel, strides, (T, N))
    ((16, 16), (4, 1), (64, 6)),   # the critic's: pads (6, 6) and (7, 8)
    ((16, 16), (4, 1), (2048, 102)),  # full width: the same pads
    ((5, 4), (2, 3), (9, 7)),      # odd totals on both axes
    ((4, 4), (2, 2), (8, 6)),      # symmetric on both: no F.pad
]


@pytest.mark.parametrize("kernel,strides,shape", CONV_CASES[:1] +
                         CONV_CASES[2:])
def test_conv2d_matches_flax(kernel, strides, shape):
    flax_conv = fnn.Conv(3, kernel, strides, padding="SAME")
    x = np.random.default_rng(0).standard_normal(
        (2, *shape, 2)).astype(np.float32)
    variables = flax_conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(flax_conv.apply(variables, jnp.asarray(x)))
    port = base.Conv(2, 3, kernel, strides, torch.float32,
                     torch.Generator().manual_seed(0))
    kernel_flax = np.asarray(variables["params"]["kernel"])
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(kernel_flax, (3, 2, 0, 1)))))
        port.bias.copy_(torch.from_numpy(np.asarray(
            variables["params"]["bias"]) + 0.1))
    ref = ref + 0.1
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("kernel,strides,shape", CONV_CASES)
def test_same_pads_per_axis(kernel, strides, shape):
    pads = jax.lax.padtype_to_pads(shape, kernel, strides, "SAME")
    ours = [base.same_conv_padding(w, k, s)
            for w, k, s in zip(shape, kernel, strides)]
    assert ours == [tuple(p) for p in pads]
    if kernel == (16, 16):
        assert ours == [(6, 6), (7, 8)]  # time symmetric, neurons not


CONV_T_CASES = [  # (kernel, strides, (pad_a, pad_b) per axis)
    ((4, 4), (2, 1), ((2, 2), (2, 1))),     # the tiny generator's layers
    ((24, 24), (2, 1), ((12, 12), (12, 11))),  # the flagship's: neurons
    ((24, 24), (2, 2), ((12, 12), (12, 12))),  # its layer 2: symmetric
    ((5, 5), (2, 1), ((3, 2), (2, 2))),     # odd K+s on the time axis
    ((2, 4), (3, 1), ((1, 2), (2, 1))),     # s > K-1: pad_a = K-1
]


@pytest.mark.parametrize("kernel,strides,pads", CONV_T_CASES)
def test_conv_transpose2d_matches_flax(kernel, strides, pads):
    """XLA's form (dilate, pad ``(pad_a, pad_b)``, correlate) with the
    padding asymmetric on one axis only where ``K + s`` is odd there."""
    flax_conv = fnn.ConvTranspose(3, kernel, strides, padding="SAME")
    x = np.random.default_rng(1).standard_normal((2, 5, 4, 2)).astype(
        np.float32)
    variables = flax_conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(flax_conv.apply(variables, jnp.asarray(x)))
    port = base.ConvTranspose(2, 3, kernel, strides, torch.float32,
                              torch.Generator().manual_seed(0))
    assert port.pads == pads
    sd = convert.generator_state_dict(
        {"ConvTranspose_0": jax.tree_util.tree_map(np.asarray,
                                                   variables["params"])})
    port.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 5 * strides[0], 4 * strides[1], 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)


# ---- the 2-D phase shuffle ------------------------------------------------

@pytest.mark.parametrize("m,n", [(2, 2), (0, 2), (3, 0), (10, 1)])
def test_phase_shuffle_2d_matches_jax(m, n):
    """Every (time, neuron) shift pair, NHWC in JAX against NCHW here;
    ``m = 0`` is layer 3's quirk: neurons only."""
    x = np.random.default_rng(m * 7 + n).standard_normal(
        (2, 9, 5, 3)).astype(np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    for t in range(-m, m + 1):
        for c in range(-n, n + 1):
            ref = np.asarray(_jax_ps2d_fixed(jnp.asarray(x), t, c, m, n))
            ours = port_shuffle.phase_shuffle_2d(nchw, (t, c), m, n)
            np.testing.assert_array_equal(
                ours.permute(0, 2, 3, 1).numpy(), ref)


def _jax_ps2d_fixed(x, t, c, m, n):
    """``phase_shuffle_2d`` of the JAX package with the shifts it would
    draw replaced by ``t`` and ``c``: its time axis then its neuron axis."""
    if m > 0:
        x = jax_shift_axis(x, jnp.asarray(t), m, 1)
    if n > 0:
        x = jax_shift_axis(x, jnp.asarray(c), n, 2)
    return x


def test_phase_shuffle_2d_draws_as_jax(recorder):
    """The recording stand-in draws what ``phase_shuffle_2d`` draws: the
    same output from the same key."""
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, 9, 5, 3)).astype(np.float32))
    for m in (0, 2):
        key = jax.random.PRNGKey(m + 4)
        ours = jax_calciumgan2d.phase_shuffle_2d(x, key, m, 2)
        np.testing.assert_array_equal(np.asarray(ours),
                                      np.asarray(jax_ps2d(x, key, m, 2)))
        assert len(recorder.take()["shift"]) == (2 if m else 1)


def test_folded_rows_stay_under_the_grid_cap():
    """At full width (2048 x 102, units 64, the concat batch of 128 rows)
    every reflect pad the critic's shuffles make keeps its two leading
    axes under CUDA's 65,535 grid blocks."""
    cfg = Config(model="calciumgan2d", signal_shape=(2048, 102, 1),
                 num_channels=1, num_units=64, m=10, n=2)
    _, dis = get_models(cfg, rng=torch.Generator().manual_seed(0))
    width, worst = 2048, 0
    for i, conv in enumerate(dis.conv[:4]):
        width //= 4
        shape = (128, conv.weight.shape[0], width, 102)
        axes = ([2] if dis.layer_m[i] > 0 else []) + [3]
        for axis in axes:
            rows, planes, _ = port_shuffle.folded_shape(shape, axis)
            worst = max(worst, rows, planes)
    assert 0 < worst <= 65535


# ---- the nets -------------------------------------------------------------

def flax_generator(bf16, seed=0, **kw):
    """A Flax ``Generator2D``'s variables (random norm affines and running
    statistics) and the port's generator with them."""
    sizes = dict(sequence_length=T, num_neurons=N, num_channels=1,
                 noise_dim=4, num_units=4, kernel_size=4, strides=2,
                 layer_norm=True, normalize=True)
    sizes.update(kw)
    flax_gen = jax_2d.Generator2D(
        dtype=jnp.bfloat16 if bf16 else jnp.float32, **sizes)
    variables = jax.tree_util.tree_map(np.asarray, flax_gen.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, sizes["noise_dim"])),
        training=False))
    rng = np.random.default_rng(seed)
    for collection in variables.values():
        for name, group in collection.items():
            if not name.startswith("Norm_"):
                continue
            for norm in group.values():
                for leaf, value in norm.items():
                    centre = 1.0 if leaf in ("scale", "var") else 0.0
                    norm[leaf] = (centre + 0.1 * rng.standard_normal(
                        value.shape)).astype(np.float32)
    port = Generator2D(dtype=torch.bfloat16 if bf16 else torch.float32,
                       rng=torch.Generator().manual_seed(seed), **sizes)
    port.load_state_dict(convert.generator_state_dict(
        variables["params"], "calciumgan2d", variables.get("batch_stats")))
    return flax_gen, variables, port


def run_generator(flax_gen, variables, port, noise):
    """Both generators in evaluation (BatchNorm's running statistics)."""
    ref = np.asarray(jax.jit(functools.partial(
        flax_gen.apply, training=False))(variables, jnp.asarray(noise)))
    with torch.no_grad():
        out = port(torch.from_numpy(noise)).numpy()
    return ref, out


@pytest.mark.parametrize("layer_norm,normalize,num_channels,batch_norm", [
    (True, True, 1, False), (True, False, 1, False), (False, True, 1, False),
    (False, False, 2, False), (True, True, 1, True)])
def test_generator2d_matches_flax_f32(layer_norm, normalize, num_channels,
                                      batch_norm):
    flax_gen, variables, port = flax_generator(
        False, layer_norm=layer_norm, normalize=normalize,
        num_channels=num_channels, batch_norm=batch_norm)
    noise = np.random.default_rng(7).standard_normal((5, 4)).astype(
        np.float32)
    ref, out = run_generator(flax_gen, variables, port, noise)
    assert out.shape == ref.shape == (5, T, N, num_channels)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("layer_norm,normalize,num_channels,batch_norm", [
    (True, True, 1, False), (True, False, 2, False), (False, False, 2, False),
    (True, True, 2, True)])
def test_generator2d_matches_flax_bf16(layer_norm,
                                       normalize, num_channels, batch_norm):
    flax_gen, variables, port = flax_generator(
        True, num_units=2, layer_norm=layer_norm, normalize=normalize,
        num_channels=num_channels, batch_norm=batch_norm)
    noise = np.random.default_rng(8).standard_normal((6, 4)).astype(
        np.float32)
    ref, out = run_generator(flax_gen, variables, port, noise)
    assert out.shape == ref.shape == (6, T, N, num_channels)
    assert out.dtype == np.float32  # last Dense cast to f32 before sigmoid
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_TOL)


def flax_discriminator(rec, bf16, m, n, seed=0, units=None):
    """Units 2 in float32, :data:`BF16_CRITIC_UNITS` in bfloat16."""
    units = units or (BF16_CRITIC_UNITS if bf16 else 2)
    flax_dis = jax_2d.Discriminator2D(
        num_units=units, m=m, n=n,
        dtype=jnp.bfloat16 if bf16 else jnp.float32)
    variables = flax_dis.init({"params": jax.random.PRNGKey(seed),
                               "phase": jax.random.PRNGKey(seed + 1)},
                              jnp.zeros((1, T, N, 1)))
    rec.take()  # init's draws
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port = Discriminator2D(T, N, 1, num_units=units, m=m, n=n,
                           dtype=torch.bfloat16 if bf16 else torch.float32,
                           rng=torch.Generator().manual_seed(seed))
    port.load_state_dict(convert.discriminator_state_dict(params,
                                                          "calciumgan2d"))
    return flax_dis, variables, port


def run_discriminator(rec, flax_dis, variables, port, x):
    ref = np.asarray(jax.jit(flax_dis.apply)(
        variables, jnp.asarray(x), rngs={"phase": jax.random.PRNGKey(2)}))
    draws = rec.take().get("shift", [])
    replay = Replay({"shift": draws})
    with torch.no_grad():
        out = port(torch.from_numpy(x),
                   *port.draw_inputs(replay, len(x), False)).numpy()
    assert replay.left() == {}
    return ref, out, len(draws)


def critic_input(seed=1):
    return (np.random.default_rng(seed).random((5, T, N, 1))
            * CRITIC_INPUT_SCALE).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n,draws", [(2, 2, 7), (0, 2, 4), (3, 0, 3),
                                       (0, 0, 0)])
def test_discriminator2d_matches_flax(recorder, bf16, m, n, draws):
    # layers 0-2 shift time by m and neurons by n, layer 3 neurons only
    flax_dis, variables, port = flax_discriminator(recorder, bf16, m, n)
    ref, out, drawn = run_discriminator(recorder, flax_dis, variables, port,
                                        critic_input())
    assert drawn == draws
    assert out.shape == ref.shape == (5, 1) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=BF16_TOL if bf16 else F32_TOL)


def test_bf16_bound_rejects_float32(recorder):
    """The port's float32 nets on Flax's bfloat16 weights and inputs fall
    outside ``BF16_TOL``: the bound tells the two precisions apart."""
    flax_gen, variables, _ = flax_generator(True, num_units=2)
    _, _, f32_gen = flax_generator(False, num_units=2)
    f32_gen.load_state_dict(convert.generator_state_dict(
        variables["params"], "calciumgan2d"))
    noise = np.random.default_rng(8).standard_normal((6, 4)).astype(
        np.float32)
    ref, out = run_generator(flax_gen, variables, f32_gen, noise)
    assert np.abs(out - ref).max() > 100 * BF16_TOL
    flax_dis, dvars, _ = flax_discriminator(recorder, True, 2, 2)
    _, _, f32_dis = flax_discriminator(recorder, False, 2, 2,
                                       units=BF16_CRITIC_UNITS)
    ref, out, _ = run_discriminator(recorder, flax_dis, dvars, f32_dis,
                                    critic_input())
    assert np.abs(out - ref).max() > 100 * BF16_TOL


def test_discriminator2d_flattens_time_neuron_channel(recorder):
    """A (channel, time, neuron) flatten of the last map must fail the
    float32 bound: the Dense weights carry over only in JAX's order."""
    flax_dis, variables, port = flax_discriminator(recorder, False, 2, 2)
    w = port.dense.weight.detach().reshape(1, 1, N, 10)  # (1, T', N, C')
    with torch.no_grad():
        port.dense.weight.copy_(w.permute(0, 3, 1, 2).reshape(1, -1))
    ref, out, _ = run_discriminator(recorder, flax_dis, variables, port,
                                    critic_input())
    assert np.abs(out - ref).max() > 100 * F32_TOL


def test_single_channel_layer_norm_keeps_gradient_flow():
    """At C = 1 the last Norm has no LayerNorm (a trainable constant that
    would cut every gradient below it): the output depends on the noise and
    the first ConvTranspose receives a nonzero gradient, with
    ``--batch_norm`` too, whose BatchNorm is kept at C = 1."""
    for batch_norm in (False, True):
        cfg = Config(**tiny_2d(batch_norm=batch_norm))
        gen, _ = get_models(cfg, rng=torch.Generator().manual_seed(0))
        assert gen.norm[4].layer_norm is False
        assert (gen.norm[4].batch_norm is not None) == batch_norm
        noise = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (4, cfg.noise_dim)).astype(np.float32))
        out = gen(noise, True)
        assert float(out.detach().std(0).mean()) > 0.0
        out.square().sum().backward()
        assert float(gen.conv_transpose[0].weight.grad.abs().max()) > 0.0


def test_build_refuses_an_odd_neuron_count():
    cfg = Config(**tiny_2d(signal_shape=(64, 5, 1), num_neurons=5))
    with pytest.raises(ValueError, match="even neuron count"):
        get_models(cfg)
    _, dis = get_models(Config(**tiny_2d()))
    with pytest.raises(ValueError, match="4 .time, neuron. shift pairs"):
        dis(torch.zeros(1, T, N, 1), [(0, 0)])


def test_convert_round_trip():
    _, variables, port = flax_generator(False, batch_norm=True,
                                        num_channels=2)
    sd = port.state_dict()
    back = convert.flax_generator_variables(sd, "calciumgan2d")
    assert back["params"]["ConvTranspose_0"]["kernel"].shape == (
        4, 4, 4, 20)  # (kh, kw, Cin, Cout)
    assert set(back["batch_stats"]) == {f"Norm_{i}" for i in range(5)}
    for collection in ("params", "batch_stats"):
        flat = jax.tree_util.tree_leaves_with_path(variables[collection])
        got = dict(jax.tree_util.tree_leaves_with_path(back[collection]))
        assert len(flat) == len(got)
        for path, leaf in flat:
            np.testing.assert_array_equal(got[path], leaf)
    again = convert.generator_state_dict(back["params"], "calciumgan2d",
                                         back["batch_stats"])
    assert set(again) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)
    _, dis = get_models(Config(**tiny_2d()),
                        rng=torch.Generator().manual_seed(1))
    dparams = convert.flax_discriminator_params(dis.state_dict(),
                                                "calciumgan2d")
    assert dparams["Conv_0"]["kernel"].shape == (16, 16, 1, 2)
    assert dparams["Dense_0"]["kernel"].shape == (1 * N * 10, 1)
    again = convert.discriminator_state_dict(dparams, "calciumgan2d")
    for k, v in dis.state_dict().items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)


# ---- one WGAN-GP step -----------------------------------------------------

_JAX_STEPS = {}


def jax_step(rec, bf16, units):
    """The JAX step from the shared weights (once per configuration): ``(new
    state, logs, draws)`` on the host. The draws do not depend on the
    dtype."""
    key = (bf16, units)
    if key not in _JAX_STEPS:
        _, _, jalgo, jstate = make_pair(rec, model="calciumgan2d",
                                        mixed_precision=bf16,
                                        num_units=units)
        new, logs = jax.jit(jalgo.train_step)(
            jstate, jnp.asarray(real_batch(shape=(T, N, 1))),
            jax.random.PRNGKey(1))
        _JAX_STEPS[key] = (*jax.tree_util.tree_map(np.asarray, (new, logs)),
                           rec.take())
    return _JAX_STEPS[key]


def moment_gap(a, b, name, to_state_dict):
    """Largest difference of two JAX states' first moments of net
    ``name``, over b's largest."""
    mu_a = to_state_dict(getattr(a, name).opt_state[0].mu)
    mu_b = to_state_dict(getattr(b, name).opt_state[0].mu)
    scale = max(float(v.abs().max()) for v in mu_b.values())
    return max(float((mu_a[k] - mu_b[k]).abs().max()) for k in mu_b) / scale


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wgan_gp_step_matches_jax(recorder, bf16):
    """float32: the 1-D step's bounds. bfloat16: the losses by the 1-D
    step's bounds; the gradients (Adam's first moments) within
    ``BF16_STEP_GAP`` times the distance of JAX's own bfloat16 step from its
    float32 one on the same draws, over the net's largest moment. The
    critic's largest moment is its last convolution's bias, a sum over the
    real and the fake rows that cancels, and bfloat16 keeps only its
    rounding: JAX's two precisions differ there by 0.097 of it, the port's
    bfloat16 and JAX's by 0.163 (measured); two runs that each lie ``gap``
    from float32 differ by up to twice it."""
    units = BF16_CRITIC_UNITS if bf16 else 2
    new, jlogs, draws = jax_step(recorder, bf16, units)
    # 3 noise batches and 2 alphas (n_critic 2); 7 shifts a critic pass
    # (time and neurons on layers 0-2, neurons on layer 3) over 5 passes
    assert {k: len(v) for k, v in draws.items()} == {
        "noise": 3, "alpha": 2, "shift": 35}
    algo, state, _, _ = make_pair(recorder, model="calciumgan2d",
                                  mixed_precision=bf16, num_units=units)
    replay = Replay(draws)
    logs = algo.train_step(state, torch.from_numpy(real_batch(
        shape=(T, N, 1))), replay)
    assert replay.left() == {}
    check_logs(jlogs, logs, bf16)
    if not bf16:
        check_step(new, state, bf16)
        return
    reference, _, _ = jax_step(recorder, False, units)
    for name, to_sd in (("generator", convert.generator_state_dict),
                        ("discriminator", convert.discriminator_state_dict)):
        net = getattr(state, name)
        assert net.step == int(getattr(new, name).step)
        gap = moment_gap(new, reference, name, to_sd)
        err = grad_errors(moments(getattr(new, name), net, to_sd), True)
        assert err <= BF16_STEP_GAP * gap, (name, err, gap)


# ---- the slice's path -----------------------------------------------------

def test_conv2d_path_end_to_end(tmp_path):
    """On the CPU at a tiny size, the four commands of the conv2d path:
    ``generate_tfrecords --conv2d``, ``main --model calciumgan2d
    --batch_norm --save_generated last``, ``compute_metrics`` and
    ``generate --spikes``; the epoch file and the served samples come out
    ``(rows, T, N)`` after the channel axis is squeezed."""
    rng = np.random.default_rng(11)
    pkl = str(tmp_path / "rec.pkl")
    with open(pkl, "wb") as f:
        # a recording's first two rows are not neurons (segments.py)
        pickle.dump({"signals": rng.random((N + 2, 1200)).astype(
            np.float32), "oasis": (rng.random((N + 2, 1200)) < 0.05).astype(
                np.float32)}, f)
    records, run = str(tmp_path / "records"), str(tmp_path / "run")
    generate_tfrecords.cli(["--input", pkl, "--output_dir", records,
                            "--sequence_length", str(T), "--stride", "16",
                            "--normalize", "--conv2d", "--validation_size",
                            "12", "--verbose", "0"])
    port_main.cli(["--input_dir", records, "--output_dir", run,
                   "--model", "calciumgan2d", "--batch_size", "8",
                   "--num_units", "2", "--kernel_size", "4", "--noise_dim",
                   "4", "--epochs", "2", "--n_critic", "2", "--m", "2",
                   "--n", "2", "--layer_norm", "--batch_norm",
                   "--checkpoint_every", "1", "--save_generated", "last",
                   "--device", "cpu", "--verbose", "0"])
    cfg = Config(output_dir=run, verbose=0).load()
    assert cfg.model == "calciumgan2d" and cfg.signal_shape == (T, N, 1)
    info = io.load_generated_info(cfg)
    assert sorted(info) == [1]
    fake = h5.get(info[1]["filename"], "signals")
    assert fake.shape == (12, T, N) and bool(np.isfinite(fake).all())

    config, options = compute_metrics.parse_args(
        ["--output_dir", run, "--no_plots", "--device", "cpu",
         "--verbose", "0"])
    results = compute_metrics.main(config, **options)
    assert np.isfinite(results[1]["firing_rate_kl"])
    assert h5.get_shape(info[1]["filename"], "spikes") == (12, T, N)

    out = str(tmp_path / "samples.h5")
    generate_mod.cli(["--output_dir", run, "--num_samples", "5",
                      "--batch_size", "4", "--spikes", "--device", "cpu",
                      "--out", out, "--verbose", "0"])
    signals, spikes = h5.get(out, "signals"), h5.get(out, "spikes")
    assert signals.shape == spikes.shape == (5, T, N)
    assert spikes.dtype == np.int8 and bool(np.isfinite(signals).all())
