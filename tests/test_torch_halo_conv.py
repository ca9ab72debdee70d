"""The port's halo-exchange convolutions
(``calciumgan_tpu_torch.parallel.halo_conv``) in 2 and 4 gloo ranks
against JAX's ``halo_conv1d`` on the 8-device mesh, the unsharded
``lax.conv_general_dilated`` and Flax's ``ConvTranspose``, on the cases of
``tests/test_halo_conv.py:23`` and ``tests/test_seq_parallel.py``
(rtol/atol 1e-5; the transposed conv atol 2e-5, as there).

The exchange is linear, and its backward is its adjoint: the gradient of
``sum(out * cotangent)`` with respect to the input, gathered from the
ranks, equals the unsharded convolution's (torch's autograd on the whole
sequence, the same functions with no group), and so does each rank's share
of the weight's gradient summed over the ranks. The two rejections are
JAX's, with its messages.

All rank work runs in one launch of 2 ranks and one of 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from calciumgan_tpu.parallel.halo_conv import make_halo_conv1d
from calciumgan_tpu.parallel.mesh import DATA_AXIS, create_mesh
from calciumgan_tpu_torch import convert
from calciumgan_tpu_torch.parallel import halo_conv
from calciumgan_tpu_torch.parallel import launch as launch_lib
import torch_rank_helpers as ranks

torch.set_num_threads(1)

TIMEOUT = 300
TOL = 1e-5
TRANSPOSE_ATOL = 2e-5
CONV_CASES = [(24, 2, 256), (24, 1, 128), (4, 2, 64), (5, 1, 64),
              (3, 3, 192)]
TRANSPOSE_CASES = [(24, 2), (4, 2), (3, 4), (5, 1)]
WORLDS = (2, 4)


def _conv_inputs(K, stride, W):
    rng = np.random.default_rng(K * 1000 + stride * 100 + W)
    x = rng.normal(size=(2, W, 3)).astype(np.float32)
    kernel = rng.normal(size=(K, 3, 5)).astype(np.float32)
    cot = rng.normal(size=(2, 5, -(-W // stride))).astype(np.float32)
    return x, kernel, cot


def _transpose_inputs(K, stride):
    import flax.linen as nn
    rng = np.random.default_rng(K * 10 + stride)
    x = rng.standard_normal((2, 256, 3)).astype(np.float32)
    mod = nn.ConvTranspose(5, kernel_size=(K,), strides=(stride,),
                           padding="SAME")
    variables = mod.init(jax.random.PRNGKey(K), jnp.asarray(x))
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    cot = rng.normal(size=(2, 5, 256 * stride)).astype(np.float32)
    return x, variables["params"], want, cot


def _ncw(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1)))


@pytest.fixture(scope="module")
def rank_results():
    jobs = []
    for K, s, W in CONV_CASES:
        x, kernel, cot = _conv_inputs(K, s, W)
        jobs.append((("conv", K, s, W), ranks.rank_halo_conv,
                     (_ncw(x), convert._conv_weight(kernel), s, False,
                      cot)))
    for K, s in TRANSPOSE_CASES:
        x, params, _, cot = _transpose_inputs(K, s)
        jobs.append((("transpose", K, s), ranks.rank_halo_conv,
                     (_ncw(x), np.ascontiguousarray(
                         convert._conv_transpose_weight(params["kernel"])),
                      s, True, cot)))
    return {world: launch_lib.launch(ranks.rank_jobs, ["cpu"] * world,
                                     "gloo", args=(jobs,),
                                     timeout=TIMEOUT)
            for world in WORLDS}


def _unsharded(x_ncw, weight, stride, transpose, cot):
    """The same function on the whole sequence in this process (no
    group): its output and gradients."""
    x = torch.from_numpy(x_ncw).requires_grad_(True)
    w = torch.from_numpy(np.ascontiguousarray(weight)).requires_grad_(True)
    fn = (halo_conv.halo_conv_transpose1d_local if transpose
          else halo_conv.halo_conv1d_local)
    out = fn(x, w, stride, None)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("K,stride,W", CONV_CASES)
def test_halo_conv_matches_jax_and_unsharded(rank_results, world, K,
                                             stride, W):
    x, kernel, cot = _conv_inputs(K, stride, W)
    expected = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), window_strides=(stride,),
        padding="SAME", dimension_numbers=("NWC", "WIO", "NWC")))
    mesh = create_mesh(8, 1)
    jax_halo = np.asarray(make_halo_conv1d(mesh, DATA_AXIS, stride)(
        jax.device_put(x, NamedSharding(mesh, P(None, DATA_AXIS, None))),
        jax.device_put(kernel, NamedSharding(mesh, P()))))
    weight = convert._conv_weight(kernel)
    one, x_grad, w_grad = _unsharded(_ncw(x), weight, stride, False, cot)
    for res in rank_results[world]:
        got = res[("conv", K, stride, W)]
        out = np.transpose(got["out"], (0, 2, 1))
        assert out.shape == expected.shape
        np.testing.assert_allclose(out, expected, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out, jax_halo, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["out"], one, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["x_grad"], x_grad, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["w_grad"], w_grad, rtol=TOL,
                                   atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("K,stride", TRANSPOSE_CASES)
def test_halo_conv_transpose_matches_flax(rank_results, world, K, stride):
    x, params, want, cot = _transpose_inputs(K, stride)
    weight = convert._conv_transpose_weight(params["kernel"])
    bias = np.asarray(params["bias"])
    one, x_grad, w_grad = _unsharded(_ncw(x), weight, stride, True, cot)
    for res in rank_results[world]:
        got = res[("transpose", K, stride)]
        out = np.transpose(got["out"], (0, 2, 1)) + bias
        np.testing.assert_allclose(out, want, atol=TRANSPOSE_ATOL,
                                   err_msg=f"K={K} s={stride}")
        np.testing.assert_allclose(got["x_grad"], x_grad, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["w_grad"], w_grad, rtol=TOL,
                                   atol=1e-4)


def test_halo_conv_rejects_kernel_smaller_than_stride():
    x = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="kernel 2 < stride 4 is "
                                         "unsupported"):
        halo_conv.halo_conv1d_local(x, torch.zeros(2, 2, 2), 4, None)


def test_halo_conv_rejects_stride_misaligned_shards():
    """W=240 over 8 shards gives Ws=30, not divisible by stride 4 (JAX's
    own case): a rank's shard of 30 frames raises JAX's error."""
    mesh = create_mesh(8, 1)
    fn = make_halo_conv1d(mesh, DATA_AXIS, stride=4)
    x = jax.device_put(np.zeros((1, 240, 2), np.float32),
                       NamedSharding(mesh, P(None, DATA_AXIS, None)))
    k = jax.device_put(np.zeros((8, 2, 2), np.float32),
                       NamedSharding(mesh, P()))
    with pytest.raises(ValueError, match="not divisible by stride") as jx:
        fn(x, k)
    with pytest.raises(ValueError) as ours:
        halo_conv.halo_conv1d_local(torch.zeros(1, 2, 30),
                                    torch.zeros(2, 2, 8), 4, None)
    assert str(ours.value) == str(jx.value)


def test_halo_sizes_and_transpose_padding_equal_jax():
    from calciumgan_tpu.parallel import halo_conv as jax_halo
    for K in (1, 2, 3, 4, 5, 24):
        for s in (1, 2, 3, 4):
            assert halo_conv.halo_sizes(K, s) == jax_halo.halo_sizes(K, s)
            assert halo_conv._conv_transpose_same_padding(K, s) == \
                jax_halo._conv_transpose_same_padding(K, s)
