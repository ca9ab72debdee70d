"""The work counts against a hand count at a tiny shape."""

from __future__ import annotations

import pytest

from h100bench import work

# noise 2, units 1, kernel 3, 2 channels, 64 frames, stride 2: the
# generator widens 2 frames x 2 channels to 64 x 2 through filters
# 5, 4, 3, 2, 2; the critic narrows 64 frames through filters 1-5
CFG = dict(noise_dim=2, num_units=1, kernel_size=3, num_channels=2,
           sequence_length=64, strides=2, n_critic=5)


def test_generator_flops_by_hand():
    B = 3
    dense0 = 2 * B * 2 * (2 * 2)  # noise 2 -> 2 frames x 2
    convs = 2 * B * 3 * (2 * 2 * 5 + 4 * 5 * 4 + 8 * 4 * 3 + 16 * 3 * 2
                         + 32 * 2 * 2)  # frames in x kernel x Cin x Cout
    dense1 = 2 * B * 64 * 2 * 2
    assert work.generator_flops(CFG, B) == dense0 + convs + dense1


def test_critic_flops_by_hand():
    B = 3
    convs = 2 * B * 3 * (32 * 2 * 1 + 16 * 1 * 2 + 8 * 2 * 3 + 4 * 3 * 4
                         + 2 * 4 * 5)  # frames out x kernel x Cin x Cout
    dense = 2 * B * (2 * 5)
    assert work.critic_flops(CFG, B) == convs + dense


def test_train_step_flops_by_hand():
    G, D = work.generator_flops(CFG, 4), work.critic_flops(CFG, 4)
    assert work.train_step_flops(CFG, 4) == 5 * (G + 10 * D) + 3 * G + 2 * D


@pytest.mark.parametrize("traces,frames", [(1, 1), (102, 2048),
                                           (16320, 16384)])
def test_oasis_bytes(traces, frames):
    # read the trace, write calcium and spikes (float32), one flag a trace
    assert work.oasis_bytes(traces, frames) == (3 * 4 * traces * frames
                                                + 4 * traces)


def test_flagship_step_and_batch():
    import json
    from h100bench import registry
    cfg = json.loads((registry.ROOT / "h100bench" / "configs"
                      / "calciumgan-sl2048.json").read_text())
    assert work.train_step_flops(cfg, 128) == pytest.approx(11.6566e12,
                                                           rel=1e-4)
    assert work.generate_batch_seconds(cfg, 1024) == pytest.approx(
        work.generator_flops(cfg, 1024) / 989e12
        + work.oasis_bytes(104448, 2048) / 3.35e12)
