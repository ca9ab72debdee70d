"""PyTorch generator vs the JAX/Flax generator with identical weights.

Weights come from a Flax ``init`` and go through
``calciumgan_tpu_torch.convert``; the noise is numpy from a seed, handed to
both. Tolerances: float32 max abs diff <= 1e-5: the convolutions sum in
another order (about 1e-7 relative per layer), and LayerNorm multiplies
such differences by up to 1/sqrt(var + 1e-3) ~ 32 where a position's
channels are nearly equal, which layers of 3 or 4 channels often are; at
the widths below the largest difference measured was 3.2e-6. bfloat16:
<= 1e-6; the port rounds where Flax does (LeakyReLU slope rounded to bf16,
bias added after the product) and measured 0 to 6e-8 on every case below.
The bound is held to what it must catch: the same weights run in float32
differ from Flax's bfloat16 by 1.4e-4 to 0.1 on these cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu.models.calciumgan import Generator as FlaxGenerator
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.models.calciumgan import Generator

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 1e-6

CASES = pytest.mark.parametrize("kernel_size,strides,sequence_length", [
    (4, 2, 64),   # symmetric SAME padding: padding=1, output_padding=0
    (5, 2, 64),   # odd K+s: pad_a > pad_b, cropped full output
    (2, 3, 243),  # s > K-1: output_padding = s-K = 1
])


def make_pair(*, sequence_length, num_channels=6, noise_dim=4, num_units=4,
              kernel_size=4, strides=2, layer_norm=True, normalize=True,
              bf16=False, seed=0):
    kw = dict(sequence_length=sequence_length, num_channels=num_channels,
              noise_dim=noise_dim, num_units=num_units,
              kernel_size=kernel_size, strides=strides,
              layer_norm=layer_norm, normalize=normalize)
    flax_gen = FlaxGenerator(dtype=jnp.bfloat16 if bf16 else jnp.float32,
                             **kw)
    params = flax_gen.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, noise_dim)))["params"]
    # random LayerNorm affine so the scale/bias mapping is exercised too
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, group in params.items():
        if name.startswith("Norm_"):
            for leaf in ("scale", "bias"):
                shape = group["LayerNorm_0"][leaf].shape
                group["LayerNorm_0"][leaf] = (
                    1.0 * (leaf == "scale")
                    + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    torch_gen = Generator(dtype=torch.bfloat16 if bf16 else torch.float32,
                          rng=torch.Generator().manual_seed(seed), **kw)
    torch_gen.load_state_dict(convert.generator_state_dict(params))
    return flax_gen, params, torch_gen


def run_both(flax_gen, params, torch_gen, noise):
    ref = np.asarray(flax_gen.apply({"params": params}, jnp.asarray(noise)))
    with torch.no_grad():
        out = torch_gen(torch.from_numpy(noise)).numpy()
    return ref, out


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
@CASES
def test_generator_matches_flax_f32(layer_norm, normalize, kernel_size,
                                    strides, sequence_length):
    flax_gen, params, torch_gen = make_pair(
        sequence_length=sequence_length, kernel_size=kernel_size,
        strides=strides, layer_norm=layer_norm, normalize=normalize)
    noise = np.random.default_rng(7).standard_normal((5, 4)).astype(
        np.float32)
    ref, out = run_both(flax_gen, params, torch_gen, noise)
    assert out.shape == ref.shape == (5, sequence_length, 6)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
@CASES
def test_generator_matches_flax_bf16(layer_norm, normalize, kernel_size,
                                     strides, sequence_length):
    flax_gen, params, torch_gen = make_pair(
        sequence_length=sequence_length, kernel_size=kernel_size,
        strides=strides, layer_norm=layer_norm, normalize=normalize,
        bf16=True)
    noise = np.random.default_rng(8).standard_normal((6, 4)).astype(
        np.float32)
    ref, out = run_both(flax_gen, params, torch_gen, noise)
    assert out.dtype == np.float32  # last Dense cast to f32 before sigmoid
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_bf16_bound_rejects_a_float32_generator(layer_norm, normalize):
    # the port's generator in float32 on Flax's bfloat16 weights and noise
    # must fall outside BF16_TOL: the bound tells the two precisions apart
    flax_gen, params, _ = make_pair(sequence_length=64,
                                    layer_norm=layer_norm,
                                    normalize=normalize, bf16=True)
    _, _, f32_gen = make_pair(sequence_length=64, layer_norm=layer_norm,
                              normalize=normalize)
    f32_gen.load_state_dict(convert.generator_state_dict(params))
    noise = np.random.default_rng(8).standard_normal((6, 4)).astype(
        np.float32)
    ref, out = run_both(flax_gen, params, f32_gen, noise)
    assert np.abs(out - ref).max() > 100 * BF16_TOL


def test_single_channel_skips_layer_norm():
    # a size-1 channel axis has no LayerNorm (base.py:45-70): no Norm_4
    # params in Flax, no norm.4 parameters in the port
    flax_gen, params, torch_gen = make_pair(sequence_length=64,
                                            num_channels=1)
    assert "Norm_4" not in params
    assert not any(k.startswith("norm.4") for k in torch_gen.state_dict())
    noise = np.random.default_rng(9).standard_normal((3, 4)).astype(
        np.float32)
    ref, out = run_both(flax_gen, params, torch_gen, noise)
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)


def test_convert_round_trip():
    _, params, torch_gen = make_pair(sequence_length=64)
    sd = convert.generator_state_dict(params)
    assert set(sd) == set(torch_gen.state_dict())
    back = convert.flax_generator_params(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_glorot_init_from_explicit_generator():
    make = lambda seed: Generator(  # noqa: E731
        sequence_length=64, num_channels=3, noise_dim=4, num_units=8,
        kernel_size=4, rng=torch.Generator().manual_seed(seed))
    a, b, c = make(1), make(1), make(2)
    conv = a.conv_transpose[1].weight  # (Cin=40, Cout=32, K=4)
    limit = np.sqrt(6.0 / (4 * 40 + 4 * 32))  # fans count K*Cin, K*Cout
    with torch.no_grad():
        assert float(conv.abs().max()) <= limit
        assert abs(float(conv.std()) - limit / np.sqrt(3)) < 0.05 * limit
        assert float(a.conv_transpose[1].bias.abs().max()) == 0.0
    torch.testing.assert_close(a.state_dict(), b.state_dict(), rtol=0,
                               atol=0)
    assert not torch.equal(conv, c.conv_transpose[1].weight)
