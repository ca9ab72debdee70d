"""The port's ``wavegan_paper`` against the benchmark's plain PyTorch
reference of WaveGAN (``h100bench/reference/wavegan.py``,
``wgan_gp_wave.py``), which the ``wavegan-train`` cell holds the program
to on the card: the generator and the critic on the same phase shifts, in
float32 and in bfloat16, one whole WGAN-GP step at WaveGAN's Adam betas
(0.5, 0.9) on the same draws, both padding routes of the layers at odd
``K + s``, the layers' counts, and the model on the port's main path
(``main`` trains, ``generate`` serves).

Sizes: d 4, kernel 25, stride 4 (the paper's), 2048 frames (the noise
width is 2048 / 4**5 = 2), 3 channels, noise 100, batch 2. The weights are
the harness's seeded Flax-layout draws (``h100bench.loops.trainwave.
model_weights``), carried into the port by its own ``convert``; the draws
are the harness's ``Draws``, one object a side with the same seed.

Bounds, as the largest gap over the reference's largest output:
- float32: 1e-5, float32 rounding in another order (measured <= 7.6e-7
  over six seeds: the zero-tap and cropped routes sum in another order
  than the reference's padded and dilated ones);
- bfloat16, the generator: 1.5e-2, the program's bf16 products,
  activations and bias additions against a float32 reference (measured
  4.7e-3 to 6.4e-3 over six seeds); a reference whose products take fp8
  e4m3 inputs (``model.fp8_cast``) reads 2.5e-2 to 5.3e-2, and must fail
  it;
- bfloat16, the critic: its output is a sum that cancels (over its
  largest output it read 3.5e-3 to 2.1e-2 over six seeds), so its gap is
  taken over the sum of the magnitudes of the last layer's terms,
  ``|features| @ |kernel| + |bias|`` on the reference's features, which
  cannot cancel: 4e-3, about one bf16 ulp at 1 (2**-8). Measured 9.5e-4
  to 2.0e-3 over eight seeds, fp8 7.4e-3 to 2.7e-2. Both bf16 checks hold
  four seeds;
- the step: as ``test_torch_calciumgan2d_reference.py``'s, at learning
  rate 1e-5 for the same reason (Adam's first step is steep where a
  gradient is near its epsilon), but each parameter's change within 4e-3
  of the learning rate: the critic's kernels reach 0.185 here (the 2-D
  test's 0.125), where a float32 ulp is 1.49e-8, and each of its two
  updates may round the two sides' new parameter to neighbouring floats
  (measured 2.98e-8, two ulps, on one element of 786).
"""

import copy
import dataclasses
import math
import os
import types

import numpy as np
import pytest
import torch

from calciumgan_tpu_torch import generate as port_generate
from calciumgan_tpu_torch import main as port_main
from calciumgan_tpu_torch import train
from calciumgan_tpu_torch.config import Config
from calciumgan_tpu_torch.data import segments
from calciumgan_tpu_torch.models import base, calciumgan, get_models, wavegan
from calciumgan_tpu_torch.utils import h5, tracing
from h100bench import inputs, program
from h100bench.loops import trainwave
from h100bench.reference import model as ref_model
from h100bench.reference import wavegan as ref_wavegan
from h100bench.reference import wgan_gp_wave

torch.set_num_threads(1)

CFG = dict(model="wavegan_paper", algorithm="wgan-gp", sequence_length=2048,
           num_neurons=3, num_channels=3, noise_dim=100, num_units=4,
           kernel_size=25, strides=4, m=2, activation="leakyrelu",
           layer_norm=False, batch_norm=False, mixed_precision=False,
           n_critic=2, gradient_penalty=10.0, learning_rate=1e-5,
           adam_beta1=0.5, adam_beta2=0.9, ema=0.0, normalize=False,
           signals_min=-1.0, signals_max=1.0)
MIX = dict(batch_size=2, rows=4, data={"g": 0.95, "rate": 0.02,
                                       "noise": 0.3})
SEED = 2 ** 33 + 3
SEEDS = (SEED, 1, 2 ** 31 + 11, 99)  # the bf16 checks' seeds
F32_TOL = 1e-5
BF16_TOL = 1.5e-2
BF16_TERMS_TOL = 4e-3  # the critic's, over its terms' magnitudes
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5
CHANGE_TOL = 4e-3  # of the learning rate
SURE = 1e-3  # of a leaf's largest moment: |g| well above Adam's epsilon
SHIFTS = [1, -2, 0, 2]
ROWS = 16  # rows a forward compares


def built(cfg, seed=SEED):
    """The port's generator and critic on the harness's weights of
    ``seed``, and those weights nested."""
    config = trainwave.port_config(cfg, MIX, seed)
    gen, dis = get_models(config, rng=torch.Generator().manual_seed(0))
    gen_w, dis_w = trainwave.model_weights(cfg, seed, "cpu")
    program.load_weights(types.SimpleNamespace(generator=gen,
                                               discriminator=dis),
                         "wavegan_paper", gen_w, dis_w)
    return gen, dis, ref_model.nest(gen_w), ref_model.nest(dis_w)


def gap(port, ref) -> float:
    return float((port.float() - ref).abs().max() / ref.abs().max())


def forwards(cfg, cast=ref_model.identity_cast, seed=SEED):
    """``(port, reference)`` outputs of the generator and of the critic on
    the same noise, signals and shifts."""
    gen, dis, gen_p, dis_p = built(cfg, seed)
    z = torch.randn((ROWS, cfg["noise_dim"]),
                    generator=torch.Generator().manual_seed(1))
    x = trainwave.windows(cfg, dict(MIX, rows=ROWS), seed, "cpu")
    with torch.no_grad():
        return ((gen(z), ref_wavegan.generator(gen_p, z, CFG, cast)),
                (dis(x, SHIFTS), ref_wavegan.critic(dis_p, x, SHIFTS, CFG,
                                                    cast)))


def critic_terms(seed) -> torch.Tensor:
    """Per row, the sum of the magnitudes of the critic's last terms,
    ``|features| @ |kernel| + |bias|``, on the float32 reference's
    features (its critic with the identity for the last layer)."""
    _, _, _, dis_p = built(CFG, seed)
    x = trainwave.windows(CFG, dict(MIX, rows=ROWS), seed, "cpu")
    last = dis_p["Dense_0"]
    n = last["kernel"].shape[0]
    with torch.no_grad():
        features = ref_wavegan.critic(
            dict(dis_p, Dense_0={"kernel": torch.eye(n),
                                 "bias": torch.zeros(n)}), x, SHIFTS, CFG)
    return features.abs() @ last["kernel"].abs() + last["bias"].abs()


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "critic"])
def test_float32_matches_the_reference(net):
    port, ref = forwards(CFG)[net]
    assert port.dtype == torch.float32
    assert port.shape == ref.shape
    assert gap(port, ref) <= F32_TOL


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "critic"])
def test_bfloat16_matches_the_reference_and_fp8_does_not(net):
    for seed in SEEDS:
        port, ref = forwards(dict(CFG, mixed_precision=True),
                             seed=seed)[net]
        _, fp8 = forwards(CFG, cast=ref_model.fp8_cast, seed=seed)[net]
        if net == 0:
            assert gap(port, ref) <= BF16_TOL < gap(fp8, ref), seed
        else:
            terms = critic_terms(seed)
            assert float(((port.float() - ref).abs() / terms).max()) \
                <= BF16_TERMS_TOL < float(((fp8 - ref).abs()
                                           / terms).max()), seed
        assert gap(fp8, ref) > F32_TOL


def test_shapes_at_the_published_layout():
    """d 64, K 25, s 4, z 100 at 16,384 frames x 102: the generator starts
    from 16 x 1024, the critic ends at 16 x 1024; 37 M parameters."""
    cfg = dict(CFG, sequence_length=16384, num_channels=102, num_units=64)
    shapes = (ref_wavegan.generator_shapes(cfg),
              ref_wavegan.critic_shapes(cfg))
    assert shapes[0]["Dense_0/kernel"] == (100, 16 * 1024)
    assert [shapes[0][f"ConvTranspose_{i}/kernel"] for i in range(5)] == [
        (25, 1024, 512), (25, 512, 256), (25, 256, 128), (25, 128, 64),
        (25, 64, 102)]
    assert [shapes[1][f"Conv_{i}/kernel"] for i in range(5)] == [
        (25, 102, 64), (25, 64, 128), (25, 128, 256), (25, 256, 512),
        (25, 512, 1024)]
    assert shapes[1]["Dense_0/kernel"] == (16 * 1024, 1)
    counts = [sum(math.prod(s) for s in net.values()) for net in shapes]
    assert counts == [19_227_046, 17_589_569]
    config = trainwave.port_config(cfg, dict(MIX, batch_size=64), SEED)
    gen, dis = get_models(config, device="meta")
    assert [sum(p.numel() for p in m.parameters())
            for m in (gen, dis)] == counts


def test_one_wgan_gp_step_matches_the_reference():
    config = trainwave.port_config(CFG, MIX, SEED)
    algo, _ = train.build_algorithm(config, torch.device("cpu"))
    gen_w, dis_w = trainwave.model_weights(CFG, SEED, "cpu")
    program.load_weights(algo, "wavegan_paper", gen_w, dis_w)
    state = algo.init_state()
    assert state.generator.optimizer.defaults["betas"] == (0.5, 0.9)
    real = trainwave.windows(CFG, MIX, SEED, "cpu")[:2]
    logs = algo.train_step(state, real, inputs.Draws(SEED, 0, "cpu"))

    gen0, dis0 = copy.deepcopy(gen_w), copy.deepcopy(dis_w)
    for p in (*gen_w.values(), *dis_w.values()):
        p.requires_grad_(True)
    betas = (CFG["adam_beta1"], CFG["adam_beta2"])
    opt_g = wgan_gp_wave.Adam(gen_w, CFG["learning_rate"], betas)
    opt_d = wgan_gp_wave.Adam(dis_w, CFG["learning_rate"], betas)
    losses = wgan_gp_wave.train_step(gen_w, dis_w, opt_g, opt_d, real,
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
                  for n, p in module.named_parameters()}, "wavegan_paper")
        params = program.flax_arrays(
            net, {n: p.detach() for n, p in module.named_parameters()},
            "wavegan_paper")
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


def _f64(module):
    return module.double()


@pytest.mark.parametrize("K, s, W", [(25, 4, 256), (3, 2, 16), (5, 2, 16)])
def test_asymmetric_conv_matches_the_reference(K, s, W):
    """A 1-D layer whose SAME padding is asymmetric prepends a zero tap
    and pads symmetrically: the reference's padded sums, in float64 to
    the last bits."""
    lo, hi = base.same_conv_padding(W, K, s)
    assert hi == lo + 1
    conv = _f64(base.Conv(3, 5, K, s, torch.float64,
                          torch.Generator().manual_seed(0)))
    x = torch.randn((2, 3, W), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    leaf = {"kernel": conv.weight.detach().permute(2, 1, 0),
            "bias": conv.bias.detach()}
    ref = ref_model.conv_same(x, leaf, s, ref_model.identity_cast)
    with torch.no_grad():
        np.testing.assert_allclose(conv(x).numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("K, s", [(25, 4), (3, 2), (5, 4)])
def test_cropped_conv_transpose_matches_the_reference(K, s):
    """Odd ``K + s``: ``output_padding`` would be -1, so the full output is
    cropped; the reference dilates, pads and correlates."""
    pad_a, pad_b = base.same_transpose_padding(K, s)
    assert pad_b - pad_a == -1
    layer = _f64(base.ConvTranspose(4, 3, K, s, torch.float64,
                                    torch.Generator().manual_seed(0)))
    x = torch.randn((2, 4, 8), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    leaf = {"kernel": torch.from_numpy(np.ascontiguousarray(
                np.flip(layer.weight.detach().numpy(), 2).transpose(
                    2, 0, 1))),
            "bias": layer.bias.detach()}
    ref = ref_model.conv_transpose_same(x, leaf, s, ref_model.identity_cast)
    with torch.no_grad():
        out = layer(x)
    assert out.shape == (2, 3, 8 * s)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_layers_count_what_their_routes_multiply_and_copy():
    """The cropped transposed route multiplies every (frame, tap) pair of
    its whole output: at K 25, s 4, 39 more than the kept frames take (18
    on the left, 21 on the right), 34 from 2 input frames (16 and 18). The
    critic's layers multiply a zero tap, 26 taps for 25, and copy nothing
    to pad; a 2-D layer that pads asymmetrically copies its input."""
    gen, dis, _, _ = built(CFG)
    before = tracing.totals.copy()
    calls = tracing.calls.copy()
    with torch.no_grad():
        x = gen(torch.zeros((3, CFG["noise_dim"])))
        dis(x, SHIFTS)
    counted, called = tracing.totals - before, tracing.calls - calls
    # (input frames, Cin, Cout, pairs cropped) a transposed layer, 25
    # taps, batch 3
    layers = [(2, 64, 32, 34), (8, 32, 16, 39), (32, 16, 8, 39),
              (128, 8, 4, 39), (512, 4, 3, 39)]
    assert counted["conv_transpose1d/products"] == sum(
        3 * w * 25 * a * b for w, a, b, _ in layers)
    assert counted["conv_transpose1d/work_products"] == sum(
        3 * (w * 25 - cropped) * a * b for w, a, b, cropped in layers)
    assert called["conv_transpose1d/products"] == 5
    # (output frames, Cin, Cout) a critic layer
    layers = [(512, 3, 4), (128, 4, 8), (32, 8, 16), (8, 16, 32),
              (2, 32, 64)]
    assert counted["conv/products"] == sum(3 * w * 26 * a * b
                                           for w, a, b in layers)
    assert counted["conv/work_products"] == sum(3 * w * 25 * a * b
                                                for w, a, b in layers)
    assert called["conv/products"] == 5
    assert not any(name.endswith("pad_bytes") for name in called)
    # 2-D: time (1, 1), neuron (1, 1) pads symmetrically, nothing copied
    conv2d = base.Conv(1, 2, (4, 3), (2, 1), torch.float32,
                       torch.Generator().manual_seed(0))
    before = tracing.totals.copy()
    with torch.no_grad():
        conv2d(torch.zeros((2, 1, 16, 5)))
    counted = tracing.totals - before
    assert counted["conv/products"] == counted["conv/work_products"] \
        == 2 * 8 * 5 * 2 * 12
    assert counted["conv/pad_bytes"] == 0
    # neuron axis K 4, s 1 pads (1, 2): a float32 copy of 2 x 18 x 8, no
    # zero tap
    conv2d = base.Conv(1, 2, (4, 4), (2, 1), torch.float32,
                       torch.Generator().manual_seed(0))
    before = tracing.totals.copy()
    with torch.no_grad():
        conv2d(torch.zeros((2, 1, 16, 5)))
    counted = tracing.totals - before
    assert counted["conv/pad_bytes"] == 2 * 18 * 8 * 4
    assert counted["conv/products"] == counted["conv/work_products"] \
        == 2 * 8 * 5 * 2 * 16


@pytest.mark.parametrize("K, s", [(25, 4), (24, 2), (3, 2), (5, 4), (2, 4)])
def test_transposed_counts_match_pairs_counted_one_by_one(K, s):
    """``_kept_taps`` against the pairs counted one by one, from 1 to 9
    input frames; a layer whose route crops counts every pair as its
    products, one that pads in cuDNN's call the kept pairs alone."""
    pad_a, pad_b = base.same_transpose_padding(K, s)
    start = K - 1 - pad_a
    for width in range(1, 10):
        pairs = sum(start <= i * s + k < start + width * s
                    for i in range(width) for k in range(K))
        assert base._kept_taps(width, K, s, start) == pairs
    layer = base.ConvTranspose(2, 3, K, s, torch.float32,
                               torch.Generator().manual_seed(0))
    before = tracing.totals.copy()
    with torch.no_grad():
        layer(torch.zeros((2, 2, 5)))
    counted = tracing.totals - before
    every = 2 * 2 * 3 * 5 * K
    kept = 2 * 2 * 3 * base._kept_taps(5, K, s, start)
    assert counted["conv_transpose1d/work_products"] == kept
    assert counted["conv_transpose1d/products"] == (
        every if pad_b < pad_a else kept)


def test_wavegan_alias_still_resolves_to_calciumgan():
    config = Config(model="wavegan", signal_shape=(64, 3), num_channels=3,
                    sequence_length=64, num_units=2, kernel_size=4,
                    noise_dim=4)
    gen, dis = get_models(config)
    assert isinstance(gen, calciumgan.Generator)
    assert isinstance(dis, calciumgan.Discriminator)
    gen, dis = get_models(dataclasses.replace(
        config, model="wavegan_paper", kernel_size=25, strides=4,
        sequence_length=2048, signal_shape=(2048, 3)))
    assert isinstance(gen, wavegan.Generator)
    assert isinstance(dis, wavegan.Discriminator)


def test_main_trains_and_generate_serves(tmp_path):
    rng = np.random.default_rng(7)
    data = {"signals": rng.random((3, 2048 + 7 * 256)).astype(np.float32),
            "oasis": (rng.random((3, 2048 + 7 * 256)) < 0.05).astype(
                np.float32)}
    signals, spikes, meta = segments.preprocess(data, 2048, 256,
                                                do_normalize=True,
                                                is_dg_data=True)
    records = str(tmp_path / "records")
    segments.write_dataset(records, signals, spikes, meta, 2048, 256,
                           validation_size=2, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    run = str(tmp_path / "run")
    port_main.cli([
        "--input_dir", records, "--output_dir", run, "--model",
        "wavegan_paper", "--batch_size", "2", "--num_units", "4",
        "--kernel_size", "25", "--strides", "4", "--noise_dim", "100",
        "--m", "2", "--epochs", "1", "--n_critic", "2", "--adam_beta1",
        "0.5", "--adam_beta2", "0.9", "--device", "cpu", "--verbose", "0"])
    config = Config(output_dir=run, verbose=0).load()
    assert (config.model, config.adam_beta1, config.adam_beta2) == (
        "wavegan_paper", 0.5, 0.9)
    assert os.listdir(os.path.join(run, "checkpoints"))
    out = str(tmp_path / f"samples{h5.default_suffix()}")
    port_generate.cli(["--output_dir", run, "--num_samples", "3",
                       "--batch_size", "2", "--device", "cpu", "--out", out,
                       "--verbose", "0"])
    served = h5.get(out, "signals")
    assert served.shape == (3, 2048, 3) and np.isfinite(served).all()


def test_wavegan_refuses_normalisation_layers():
    config = trainwave.port_config(dict(CFG, layer_norm=True), MIX, SEED)
    with pytest.raises(ValueError, match="normalisation"):
        get_models(config)
    assert wavegan.CRITIC_SLOPE == ref_wavegan.SLOPE == 0.2
