"""One train step of the port against the JAX package's on the same weights
and the same random draws.

The weights are the port's glorot draws, carried to a JAX train state by
``calciumgan_tpu_torch.convert`` (no Flax ``init`` to compile; the
generator and discriminator parity tests load Flax-initialised weights the
other way). The JAX step runs under ``jax.jit``, once per configuration;
its draws are captured by a
test-side wrapper: ``jax.debug.callback(ordered=True)`` records each phase
shift (in a stand-in for ``calciumgan_tpu.models.calciumgan.phase_shuffle``
that draws exactly as the original), each noise batch (around the
algorithm's ``get_noise``) and each GP alpha (around ``interpolate``), in
execution order. The port's step then takes them from a replaying object
with the methods of ``algorithms.gan.Draws``. A WGAN-GP step at
``n_critic`` 2 draws 3 noise batches, 2 alphas and 20 shifts (4 for each
critic pass, 4 for each GP pass, 4 for the generator step); the vanilla
GAN's one forward is traced under both gradients, so its noise and shifts
are recorded twice, equal, and replayed once.

Bounds (sizes: sl64, 6 neurons, units 4, kernels 4 and 5, batch 8, lr
1e-5):
- losses, GP and signal metrics: float32 rtol 1e-5 + atol 1e-6 (measured
  <= 5e-7 absolute: Adam's first critic step is ``lr * g / (|g| + eps)``,
  steep where ``|g|`` is near ``eps = 1e-7``, so the generator loss after
  the critic's updates moves with ``lr``); bfloat16 rtol 1e-4 + atol 1e-4
  (measured 4.6e-5 on a generator loss of 3e-3: a mean of critic outputs
  near 5e-2, each rounded to bf16, that cancel);
- gradients, read as Adam's first moments after the step (one step of
  the generator: ``0.1 g``; two of the critic: ``0.09 g1 + 0.1 g2``):
  float32 max abs error <= 1e-4 of the tensor's largest moment (measured
  <= 1.5e-5; a moment that is exactly 0, as the WGAN critic's ``Dense``
  bias, must stay 0); bfloat16 <= 0.1 of the net's largest moment
  (measured <= 0.03: bf16 backward passes round each product to 8 bits in
  another order, and sums that cancel, such as the vanilla critic's
  ``Dense`` bias, keep only that rounding);
- the generator's updated float32 parameters after its one Adam step,
  where its moment is above 1e-3 of the tensor's largest (``|g| >> eps``),
  to ``0.05 * lr`` (float32 rounding of parameters near 1 is ``0.012 *
  lr``). The critic's two steps are held by their moments: its second
  update divides moments that nearly cancel where ``g1 ~ -g2``.
Each bound fails on a deliberate fault (wrong GP shifts, a channel-major
flatten).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu_torch import convert
from torch_step_helpers import Replay, make_pair, real_batch, recording

torch.set_num_threads(1)

LOSS_RTOL = {False: 1e-5, True: 1e-4}
LOSS_ATOL = {False: 1e-6, True: 1e-4}
F32_GRAD_TOL = 1e-4    # of each tensor's largest moment
BF16_GRAD_TOL = 0.1    # of the net's largest moment
LR = 1e-5  # the tiny configuration's


@pytest.fixture(scope="module")
def recorder():
    with recording() as rec:
        yield rec


_JAX_STEPS = {}


def jax_step(rec, algorithm, bf16, kernel_size):
    """The JAX train step from the shared weights (computed once per
    configuration): ``(initial state, new state, logs, draws)`` on the
    host."""
    key = (algorithm, bf16, kernel_size)
    if key not in _JAX_STEPS:
        _, _, jalgo, jstate = make_pair(rec, algorithm=algorithm,
                                        mixed_precision=bf16,
                                        kernel_size=kernel_size)
        new, logs = jax.jit(jalgo.train_step)(
            jstate, jnp.asarray(real_batch()), jax.random.PRNGKey(1))
        host = jax.tree_util.tree_map(np.asarray, (new, logs))
        _JAX_STEPS[key] = (*host, rec.take())
    return _JAX_STEPS[key]


def run_train_step(rec, algorithm, bf16, kernel_size, edit=None):
    """The port's step from the same weights on the JAX step's draws
    (``edit`` may change the draws first): ``(JAX new state, JAX logs,
    port state, port logs, draws)``."""
    new, jlogs, draws = jax_step(rec, algorithm, bf16, kernel_size)
    algo, state, _, _ = make_pair(rec, algorithm=algorithm,
                                  mixed_precision=bf16,
                                  kernel_size=kernel_size)
    replayed = edit(draws) if edit else draws
    replay = Replay(replayed)
    logs = algo.train_step(state, torch.from_numpy(real_batch()), replay)
    assert replay.left() == {}
    return new, jlogs, state, logs, draws


def moments(jax_net, port_net, to_state_dict, skip=()):
    """(port, JAX) first moments per parameter name, but those in
    ``skip``."""
    mu = to_state_dict(jax_net.opt_state[0].mu)
    opt = port_net.optimizer
    return {n: (opt.state[p]["exp_avg"], mu[n])
            for n, p in port_net.module.named_parameters() if n not in skip}


def grad_errors(pairs, bf16):
    """Worst error of the moments under the bound's own scale."""
    if bf16:
        scale = max(float(ref.abs().max()) for _, ref in pairs.values())
        return max(float((a - b).abs().max()) for a, b in pairs.values()) \
            / scale
    # a tensor whose gradient is exactly 0 (the WGAN critic's Dense bias
    # cancels between real and fake) must stay exactly 0
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in pairs.values())


def check_logs(jlogs, tlogs, bf16):
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]),
                                   rtol=LOSS_RTOL[bf16], atol=LOSS_ATOL[bf16],
                                   err_msg=k)


_NETS = (("generator", convert.generator_state_dict),
         ("discriminator", convert.discriminator_state_dict))


def check_step(new, tstate, bf16, nets=_NETS, skip=()):
    """``nets``: each net's name and its Flax-to-``state_dict`` rule, the
    generator's first; parameters named in ``skip`` are left out."""
    for name, to_sd in nets:
        net = getattr(tstate, name)
        assert net.step == int(getattr(new, name).step)
        tol = BF16_GRAD_TOL if bf16 else F32_GRAD_TOL
        assert grad_errors(moments(getattr(new, name), net, to_sd, skip),
                           bf16) <= tol, name
    if bf16:
        return
    # the generator's one Adam step, where its gradient is well above eps
    pairs = moments(new.generator, tstate.generator, nets[0][1], skip)
    updated = nets[0][1](new.generator.params)
    for n, p in tstate.generator.module.named_parameters():
        if n in skip:
            continue
        _, ref_mu = pairs[n]
        sure = ref_mu.abs() > 1e-3 * ref_mu.abs().max()
        np.testing.assert_allclose(p.detach()[sure].numpy(),
                                   updated[n][sure].numpy(), rtol=0,
                                   atol=0.05 * LR, err_msg=n)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wgan_gp_step_matches_jax(recorder, bf16):
    # kernel 5, stride 2: the critic's SAME padding is asymmetric
    new, jlogs, tstate, tlogs, draws = run_train_step(
        recorder, "wgan-gp", bf16, 5)
    assert {k: len(v) for k, v in draws.items()} == {
        "noise": 3, "alpha": 2, "shift": 20}
    check_logs(jlogs, tlogs, bf16)
    check_step(new, tstate, bf16)


def _once(draws):
    # one forward traced under both gradients: each draw twice, equal
    assert len(draws["noise"]) == 2 and len(draws["shift"]) == 8
    np.testing.assert_array_equal(draws["noise"][0], draws["noise"][1])
    np.testing.assert_array_equal(draws["shift"][:4], draws["shift"][4:])
    return {"noise": draws["noise"][:1], "shift": draws["shift"][:4]}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gan_step_matches_jax(recorder, bf16):
    new, jlogs, tstate, tlogs, _ = run_train_step(recorder, "gan", bf16, 4,
                                                  edit=_once)
    check_logs(jlogs, tlogs, bf16)
    check_step(new, tstate, bf16)


def _gp_reuses_critic_shifts(draws):
    shifts = list(draws["shift"])
    for start in (0, 8):  # each critic step: 4 critic, then 4 GP shifts
        shifts[start + 4:start + 8] = shifts[start:start + 4]
    return dict(draws, shift=shifts)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_bounds_fail_with_wrong_gp_shifts(recorder, bf16):
    # the GP pass reusing the critic pass's shifts instead of its own draw
    # falls outside the gradient bound and the GP's
    new, jlogs, tstate, tlogs, _ = run_train_step(
        recorder, "wgan-gp", bf16, 5, edit=_gp_reuses_critic_shifts)
    pairs = moments(new.discriminator, tstate.discriminator,
                    convert.discriminator_state_dict)
    tol = BF16_GRAD_TOL if bf16 else F32_GRAD_TOL
    assert grad_errors(pairs, bf16) > 2 * tol
    gp, ref = float(tlogs["loss/gradient_penalty"]), float(
        jlogs["loss/gradient_penalty"])
    assert abs(gp - ref) > 10 * (LOSS_RTOL[bf16] * abs(ref) + LOSS_ATOL[bf16])


def test_flatten_fault_fails_the_loss_bound(recorder):
    # a channel-major flatten before the critic's Dense moves the losses
    # far outside their bound
    new, jlogs, draws = jax_step(recorder, "wgan-gp", False, 5)
    algo, state, _, _ = make_pair(recorder, kernel_size=5)
    dense = algo.discriminator.dense
    w = dense.weight.detach().reshape(1, -1, 4 * 5)  # (1, W', C') time-major
    with torch.no_grad():  # the weights a channel-major flatten would read
        dense.weight.copy_(w.transpose(1, 2).reshape(1, -1))
    logs = algo.train_step(state, torch.from_numpy(real_batch()),
                           Replay(draws))
    ref = float(jlogs["loss/discriminator"])
    assert abs(float(logs["loss/discriminator"]) - ref) > \
        100 * (LOSS_RTOL[False] * abs(ref) + LOSS_ATOL[False])


