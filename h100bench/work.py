"""The work the cells' algorithms need, counted from their shapes, and the
H100's peaks. Nothing here is read from the program's run.

FLOPs count the products of the convolutions and dense layers, two a
multiply-add, at the shapes the reference computes (a transposed
convolution's products without the zeros of its dilated input);
normalisations and activations are left out. A backward pass costs twice
its forward (the input's and the weights' gradients). OASIS moves 12 bytes
a frame (the trace read, calcium and spikes written, float32) and 4 a trace
(its flags), once a batch, whatever rungs the ladder reruns.
"""

from __future__ import annotations

from h100bench.reference import model

# NVIDIA's data sheet for the H100 SXM, dense rates, at its 700 W limit
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def generator_flops(cfg: dict, batch: int) -> float:
    nd, u, K, C = (cfg["noise_dim"], cfg["num_units"], cfg["kernel_size"],
                   cfg["num_channels"])
    w = model.noise_width(cfg)
    flops = 2 * batch * nd * w * nd
    c_in = nd
    for f in (5 * u, 4 * u, 3 * u, 2 * u, C):
        flops += 2 * batch * w * K * c_in * f
        c_in, w = f, w * cfg["strides"]
    return float(flops + 2 * batch * w * C * C)


def critic_flops(cfg: dict, batch: int) -> float:
    K, u = cfg["kernel_size"], cfg["num_units"]
    c_in, w = cfg["num_channels"], cfg["sequence_length"]
    flops = 0
    for i in range(5):
        f = u * (i + 1)
        w = -(-w // cfg["strides"])
        flops += 2 * batch * w * K * c_in * f
        c_in = f
    return float(flops + 2 * batch * w * c_in)


def train_step_flops(cfg: dict, batch: int) -> float:
    """One WGAN-GP step at global ``batch``. Each critic update: the
    generator's forward (G), the critic's forward and backward over real
    and fake (3 D at 2B), the penalty's forward, input gradient and the
    backward of that gradient (1 + 1 + 2 D at B). The generator update: G
    forward, the critic's forward and input gradient (2 D), G backward (2
    G)."""
    G, D = generator_flops(cfg, batch), critic_flops(cfg, batch)
    return cfg["n_critic"] * (G + 6 * D + 4 * D) + 3 * G + 2 * D


def oasis_bytes(traces: int, frames: int) -> float:
    return 12.0 * traces * frames + 4.0 * traces


def generate_batch_seconds(cfg: dict, batch: int) -> float:
    """The least device time of one served batch with spikes: the
    generator's products at the bf16 peak plus OASIS's bytes at the HBM
    peak."""
    traces = batch * cfg["num_channels"]
    return (generator_flops(cfg, batch) / PEAKS["bf16_flops"]
            + oasis_bytes(traces, cfg["sequence_length"])
            / PEAKS["hbm_bytes_per_s"])
