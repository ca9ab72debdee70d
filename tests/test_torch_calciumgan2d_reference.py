"""The port's ``calciumgan2d`` against the benchmark's plain PyTorch
reference of it (``h100bench/reference/model2d.py``, ``wgan_gp2d.py``),
which the ``conv2d-train`` cell holds the program to on the card: the
generator, the critic on the same phase shifts, one whole WGAN-GP step
(n_critic 2) on the same draws, and the transposed convolutions' counts of
products with and without the dilation's zeros.

Sizes: 64 frames x 8 neurons x 1 channel, noise 4, units 4, kernel 4,
batch 4, float32. The weights are the harness's seeded Flax-layout draws
(``h100bench.inputs.weights``), carried into the port by its own
``convert``; the draws are the harness's ``Draws``, one object a side with
the same seed. The test stays in float32: oneDNN's bfloat16 ``conv2d`` on
this CPU is wrong for 16 x 16 kernels over 4-14 input channels
(``test_torch_calciumgan2d.py``).

Bounds, each of float32 rounding in another order:
- forward: 1e-5 of the reference's largest output (measured <= 2.3e-7:
  the generator's LayerNorm over 4-20 channels scales a reordering of
  1e-7 by up to ``1/sqrt(var + 1e-3)``);
- the step's losses: rtol 1e-5 (measured <= 2e-7);
- each leaf's Adam first moment after the step: 1e-5 of the leaf's
  largest (measured <= 2.2e-6). A moment that is 0 in the reference (the
  critic's output bias, whose gradient cancels between real and fake rows)
  must be 0 in the port;
- each parameter's change, where its reference moment is above 1e-3 of
  its leaf's largest: 1e-3 of the learning rate. Adam's first steps move
  such an element by about ``lr`` (``lr * g / (|g| + 1e-7)``), and the new
  float32 parameters, up to 0.125 in magnitude here, round at 7.5e-9,
  7.5e-4 of it (measured <= 7.5e-4). Where ``|g|`` is near 1e-7 the step
  is steep in ``g`` and takes its rounding up (0.35 of a change of 7e-8 in
  the critic's layer-3 bias); those elements are held by their moments.
  The learning rate is 1e-5, as ``test_torch_train_step.py``'s: a larger
  one moves the critic's parameters in its first update, and with them
  the later passes, by that rounding.
"""

import copy
import math
import types

import numpy as np
import pytest
import torch

from calciumgan_tpu_torch import train
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.utils import tracing
from h100bench import inputs, inputs2d, program, work2d
from h100bench.reference import model as ref_model
from h100bench.reference import model2d
from h100bench.reference import wgan_gp as ref_wgan_gp
from h100bench.reference import wgan_gp2d

torch.set_num_threads(1)

CFG = dict(model="calciumgan2d", algorithm="wgan-gp", sequence_length=64,
           num_neurons=8, num_channels=1, noise_dim=4, num_units=4,
           kernel_size=4, strides=2, m=2, n=2, activation="leakyrelu",
           layer_norm=True, batch_norm=False, mixed_precision=False,
           n_critic=2, gradient_penalty=10.0, learning_rate=1e-5, ema=0.0,
           normalize=True, signals_min=0.0, signals_max=1.0)
MIX = dict(batch_size=4, rows=8, data={"g": 0.95, "rate": 0.02,
                                       "noise": 0.3})
SEED = 2 ** 33 + 4242
FORWARD_TOL = 1e-5
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5
CHANGE_TOL = 1e-3  # of the learning rate
SURE = 1e-3  # of a leaf's largest moment: |g| well above Adam's epsilon


def built(cfg, seed=SEED):
    """The port's generator and critic on the harness's weights of
    ``seed``, and those weights."""
    config = inputs2d.port_config(cfg, MIX, seed)
    gen, dis = get_models(config, rng=torch.Generator().manual_seed(0))
    gen_w, dis_w = inputs2d.model_weights(cfg, seed, "cpu")
    program.load_weights(types.SimpleNamespace(generator=gen,
                                               discriminator=dis),
                         "calciumgan2d", gen_w, dis_w)
    return gen, dis, ref_model.nest(gen_w), ref_model.nest(dis_w)


def assert_close(port, ref, tol, what):
    scale = float(ref.abs().max())
    assert float((port - ref).abs().max()) <= tol * scale, what


@pytest.mark.parametrize("layer_norm, normalize", [(True, True),
                                                   (False, False)])
def test_generator_matches_the_reference(layer_norm, normalize):
    cfg = dict(CFG, layer_norm=layer_norm, normalize=normalize)
    gen, _, gen_p, _ = built(cfg)
    z = torch.randn((4, cfg["noise_dim"]),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port = gen(z)
        ref = model2d.generator(gen_p, z, cfg)
    assert port.shape == ref.shape == (4, 64, 8, 1)
    assert_close(port, ref, FORWARD_TOL, "generator")


@pytest.mark.parametrize("m, n", [(2, 2), (0, 2), (2, 0)])
def test_critic_matches_the_reference_on_the_same_shifts(m, n):
    cfg = dict(CFG, m=m, n=n)
    _, dis, _, dis_p = built(cfg)
    x = torch.rand((4, 64, 8, 1), generator=torch.Generator().manual_seed(2))
    port_shifts, = dis.draw_inputs(inputs.Draws(SEED, 0, "cpu"), 4, True)
    ref_shifts = model2d.draw_shifts(inputs.Draws(SEED, 0, "cpu"), cfg)
    assert port_shifts == ref_shifts
    assert [t for t, _ in ref_shifts][3] == 0  # the layer-3 quirk
    with torch.no_grad():
        port = dis(x, port_shifts)
        ref = model2d.critic(dis_p, x, ref_shifts, cfg)
    assert port.shape == ref.shape == (4, 1)
    assert_close(port, ref, FORWARD_TOL, "critic")


def test_one_wgan_gp_step_matches_the_reference():
    config = inputs2d.port_config(CFG, MIX, SEED)
    algo, _ = train.build_algorithm(config, torch.device("cpu"))
    gen_w, dis_w = inputs2d.model_weights(CFG, SEED, "cpu")
    program.load_weights(algo, "calciumgan2d", gen_w, dis_w)
    state = algo.init_state()
    real = inputs2d.windows(CFG, MIX, SEED, "cpu")[:4]
    logs = algo.train_step(state, real, inputs.Draws(SEED, 0, "cpu"))

    gen0, dis0 = copy.deepcopy(gen_w), copy.deepcopy(dis_w)
    for p in (*gen_w.values(), *dis_w.values()):
        p.requires_grad_(True)
    opt_g = ref_wgan_gp.Adam(gen_w, CFG["learning_rate"])
    opt_d = ref_wgan_gp.Adam(dis_w, CFG["learning_rate"])
    losses = wgan_gp2d.train_step(gen_w, dis_w, opt_g, opt_d, real,
                                  inputs.Draws(SEED, 0, "cpu"), CFG)
    for name, value in losses.items():
        assert math.isclose(float(logs[name]), value, rel_tol=LOSS_RTOL), \
            name

    for net, opt, start, now in (("generator", opt_g, gen0, gen_w),
                                 ("discriminator", opt_d, dis0, dis_w)):
        module = getattr(state, net).module
        optimizer = getattr(state, net).optimizer
        moments = program.flax_arrays(
            net, {n: optimizer.state[p]["exp_avg"]
                  for n, p in module.named_parameters()}, "calciumgan2d")
        params = program.flax_arrays(
            net, {n: p.detach() for n, p in module.named_parameters()},
            "calciumgan2d")
        assert set(moments) == {f"{net}/{k}" for k in opt.m}
        for k in opt.m:
            ref_m = opt.m[k].double().numpy()
            port_m = moments[f"{net}/{k}"]
            if not ref_m.any():
                assert not port_m.any(), k
                continue
            np.testing.assert_allclose(
                port_m, ref_m, rtol=0, atol=LEAF_TOL * np.abs(ref_m).max(),
                err_msg=f"{net}/{k} moment")
            ref_change = (now[k] - start[k]).detach().double().numpy()
            port_change = params[f"{net}/{k}"] - start[k].double().numpy()
            sure = np.abs(ref_m) > SURE * np.abs(ref_m).max()
            np.testing.assert_allclose(port_change[sure], ref_change[sure],
                                       rtol=0,
                                       atol=CHANGE_TOL * CFG["learning_rate"],
                                       err_msg=f"{net}/{k} change")


def test_transposed_convolutions_count_their_products():
    gen, _, _, _ = built(CFG)
    before = tracing.totals.copy()
    with torch.no_grad():
        gen(torch.zeros((3, CFG["noise_dim"])))
    counted = tracing.totals - before
    products, work = work2d.generator_products(CFG, 3)
    assert counted["conv_transpose2d/products"] == products
    assert counted["conv_transpose2d/work_products"] == work
    # by hand: (input positions, Cin, Cout, sh * sw) a layer, kernel 4 x 4
    layers = [(2 * 4, 4, 20, 2), (4 * 4, 20, 12, 2), (8 * 4, 12, 8, 4),
              (16 * 8, 8, 4, 2), (32 * 8, 4, 1, 2)]
    assert work == sum(3 * p * 16 * a * b for p, a, b, _ in layers)
    assert products == sum(3 * p * 16 * a * b * z for p, a, b, z in layers)


def test_zero_share_at_the_recipe_widths():
    """60.62% of the products of the recipe's generator multiply zeros,
    whatever the batch: counted from the shapes, nothing run."""
    recipe = dict(CFG, sequence_length=2048, num_neurons=102, noise_dim=32,
                  num_units=64, kernel_size=24)
    for batch in (1, 4, 64):
        products, work = work2d.generator_products(recipe, batch)
        assert 100.0 * (1.0 - work / products) == pytest.approx(60.62,
                                                                abs=0.01)
    assert 2 * products / 64 == pytest.approx(3480.7e9, rel=1e-4)
    assert 2 * work / 64 == pytest.approx(1370.7e9, rel=1e-4)
