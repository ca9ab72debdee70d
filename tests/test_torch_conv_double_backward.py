"""The 1-D ``Conv``'s own backward (``models/base.py`` ``_Conv1d`` and
``_Conv1dGrads``): its first and second derivatives against finite
differences in float64 and against plain ``F.conv1d`` autograd in
bfloat16, the terms each backward computes, and the counter of the double
backward's weight gradients in whole WGAN-GP steps."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from calciumgan_tpu_torch.algorithms import get_algorithm
from calciumgan_tpu_torch.algorithms.gan import Draws
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.models import base, get_models
from calciumgan_tpu_torch.utils import tracing

torch.set_num_threads(1)

BF16_TOL = 3e-2  # a gradient's gap over its norm: 8 bfloat16 epsilons


class _PlainConv1d:
    """``_Conv1d`` as plain ``F.conv1d``: autograd's own backward and
    double backward."""

    @staticmethod
    def apply(x, w, stride, padding):
        return F.conv1d(x, w, stride=stride, padding=padding)


def layer(c_in, c_out, kernel, stride, dtype, seed=0):
    conv = base.Conv(c_in, c_out, kernel, stride, dtype,
                     torch.Generator().manual_seed(seed))
    with torch.no_grad():  # a bias that is not zero, so it is exercised
        conv.bias.uniform_(-0.5, 0.5)
    return conv.to(torch.float64) if dtype == torch.float64 else conv


def critic_gradients(convs, x):
    """A penalty-style pass of two layers: the input gradient with its
    graph, then each weight's gradient of the output (first order) and of
    the penalty (second order)."""
    x_hat = x.clone().requires_grad_(True)
    out = base.leaky_relu(0.2)(convs[0](x_hat))
    out = convs[1](out).float()
    grad, = torch.autograd.grad(out.sum(), x_hat, create_graph=True)
    penalty = (grad.float().flatten(1).norm(dim=1) - 1).square().mean()
    params = [p for conv in convs for p in conv.parameters()]
    first = torch.autograd.grad(out.square().mean(), params,
                                retain_graph=True)
    second = torch.autograd.grad(penalty, params[::2])  # a bias has none
    return first + second


def in_float64(conv):
    """``conv`` computing in float64 on its parameters rounded to
    bfloat16, the values its bfloat16 passes multiply."""
    twin = copy.deepcopy(conv)
    twin.dtype = torch.float64
    with torch.no_grad():
        for p in twin.parameters():
            p.data = p.to(torch.bfloat16).double()
    return twin


@pytest.mark.parametrize("kernel, stride, width", [
    (24, 2, 64),   # symmetric SAME: 11 frames on either side
    (25, 4, 64),   # asymmetric SAME (10, 11): the zero tap
    (5, 1, 20),    # stride 1
    (24, 2, 37),   # an odd input width: the last window is cut short
])
def test_conv1d_gradients(monkeypatch, kernel, stride, width):
    """float64: ``gradcheck`` and ``gradgradcheck`` of the layer in its
    input, weight and bias, so every term of both backwards is held to
    finite differences. bfloat16: a two-layer critic's first- and
    second-order gradients against plain ``F.conv1d`` autograd on the same
    values in float64. (Plain autograd in bfloat16 is no reference on this
    CPU: oneDNN's second-order weight gradients at stride 1 are off by
    about 88%, and its forward at 8 to 16 channels and 24 taps by 107%.)"""
    conv = layer(3, 4, kernel, stride, torch.float64)

    def f(x, w, b):
        return torch.func.functional_call(conv, {"weight": w, "bias": b},
                                          (x,))

    x = torch.randn(2, 3, width, dtype=torch.float64, requires_grad=True)
    inputs = (x, conv.weight.detach().clone().requires_grad_(True),
              conv.bias.detach().clone().requires_grad_(True))
    assert torch.autograd.gradcheck(f, inputs)
    assert torch.autograd.gradgradcheck(f, inputs)

    convs = [layer(3, 16, kernel, stride, torch.bfloat16, 1),
             layer(16, 32, kernel, stride, torch.bfloat16, 2)]
    x = (torch.rand(4, 3, 8 * width, generator=torch.Generator()
                    .manual_seed(3)) * 2 - 1).to(torch.bfloat16)
    program = critic_gradients(convs, x.float())
    monkeypatch.setattr(base, "_Conv1d", _PlainConv1d)
    plain = critic_gradients([in_float64(c) for c in convs], x.double())
    for got, want in zip(program, plain):
        assert got.dtype == torch.float32
        gap = (got.double() - want).norm() / want.norm()
        assert gap < BF16_TOL, (got.shape, float(gap))


def test_each_backward_computes_only_the_terms_it_is_asked_for(
        monkeypatch):
    """The first backward asks cuDNN only for the gradients the running
    backward takes, as autograd's convolution does: the input's alone for
    a penalty's gradient of its input, the weight's alone where the input
    needs none; the double backward adds the weight term and no input
    term where no weight gradient was taken first."""
    masks = []
    real = base._conv1d_backward

    def spy(g, x, w, stride, padding, mask):
        masks.append(tuple(mask))
        return real(g, x, w, stride, padding, mask)

    monkeypatch.setattr(base, "_conv1d_backward", spy)
    convs = [layer(3, 4, 25, 4, torch.float32, 1),
             layer(4, 8, 25, 4, torch.float32, 2)]
    x = torch.randn(2, 3, 64, requires_grad=True)
    out = convs[1](convs[0](x)).sum()
    grad, = torch.autograd.grad(out, x, create_graph=True)
    assert masks == [(True, False)] * 2
    masks.clear()
    weights = [conv.weight for conv in convs]
    torch.autograd.grad(grad.square().sum(), weights)
    assert sorted(masks) == [(False, True)] * 2
    masks.clear()
    torch.autograd.grad(convs[1](convs[0](x.detach())).sum(), weights)
    assert masks == [(True, True), (False, True)]


def tiny(**kw) -> Config:
    d = dict(model="calciumgan", algorithm="wgan-gp", sequence_length=64,
             num_neurons=6, num_channels=6, signal_shape=(64, 6),
             noise_dim=8, num_units=4, kernel_size=4, strides=2, m=2,
             batch_size=4, n_critic=3, normalize=True, layer_norm=True,
             signals_min=0.0, signals_max=1.0, learning_rate=1e-5,
             verbose=0)
    d.update(kw)
    return Config(**d)


CONFIGS = {
    "calciumgan": tiny(),
    "wavegan_paper": tiny(model="wavegan_paper", sequence_length=1024,
                          signal_shape=(1024, 6), num_units=2,
                          kernel_size=25, strides=4, layer_norm=False,
                          normalize=False, signals_min=-1.0),
    "calciumgan2d": tiny(model="calciumgan2d", signal_shape=(64, 6, 1),
                         num_channels=1, num_units=2, noise_dim=4, n=2),
}


@pytest.mark.parametrize("model, step, per_step", [
    ("calciumgan", "train", 5 * 3),
    ("wavegan_paper", "train", 5 * 3),
    ("calciumgan", "eval", 0),
    ("calciumgan2d", "train", 0),
])
def test_the_double_backward_counts_its_weight_gradients(model, step,
                                                         per_step):
    """A 1-D training step takes one double-backward weight gradient a
    critic layer and critic iteration (5 x ``n_critic``), each with its
    products; evaluation's penalty records no graph and a 2-D critic
    takes another route, so neither counts one."""
    config = CONFIGS[model]
    algo = get_algorithm(config, *get_models(config))
    state = algo.init_state()
    real = torch.from_numpy(np.random.default_rng(0).random(
        (config.batch_size, *config.signal_shape)).astype(np.float32))
    before = tracing.totals.copy()
    if step == "train":
        algo.train_step(state, real, Draws(1, 0, "cpu"))
    else:
        algo.eval_step(state, real, Draws(1, 0, "cpu"))
    counted = tracing.totals - before
    assert counted["conv/wgrad_double_backward"] == per_step
    if per_step:
        widths = [-(-config.sequence_length // config.strides ** k)
                  for k in range(1, 6)]
        convs = algo.discriminator.conv
        products = sum(config.batch_size * conv.weight.shape[0] * width
                       * conv.weight.shape[1]
                       * (conv.kernel_size[0] + (config.kernel_size == 25))
                       for conv, width in zip(convs, widths))
        assert counted["conv/wgrad_double_backward_products"] \
            == config.n_critic * products
