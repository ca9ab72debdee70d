"""The serving loop: ``calciumgan_tpu_torch.generate.generate(...,
batch_size, with_spikes=True)`` batch after batch, each batch's signals and
spikes handed to the caller as host arrays.

Set-up makes the served model's weights (one a configuration), builds the
generator inside ``generate`` and runs the mix's ``warm_batches`` (the
OASIS libraries load or build, cuDNN picks its algorithms). The window
takes batches until the host clock passes ``--seconds`` at a batch
boundary. Of every batch it keeps
``kept_rows_per_batch`` rows drawn from the seed; after the window
``checked_rows`` of those, drawn from the seed among every batch handed
over, are held to the reference: the generator in float32 on the same
noise (worked out again from ``generate``'s seed), and float64 OASIS on the
served signals.
"""

from __future__ import annotations

import sys
from time import perf_counter, time

import numpy as np
import torch

from h100bench import compare, inputs, program, trace, work
from h100bench.reference import model as ref_model
from h100bench.reference import oasis as ref_oasis


def served_weights(cfg: dict, device) -> dict:
    """The served generator's weights: one model a configuration, drawn
    from its ``served_weights_seed``, so every ``--seed`` serves the same
    model (and OASIS the same work) to other requests."""
    return inputs.model_weights(cfg, cfg["served_weights_seed"], device)[0]


def noise_rows(seed: int, batch: int, noise_dim: int, wanted: dict,
               device) -> dict:
    """``{(batch index, row): noise}`` as ``generate`` draws it: ``(batch,
    noise_dim)`` standard normals a batch from one generator on the device
    seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for b in range(max(b for b, _ in wanted) + 1):
        z = torch.randn((batch, noise_dim), generator=gen, device=device)
        out.update({(b, r): z[r] for bb, r in wanted if bb == b})
    return out


def reference_signals(cfg, gen_w, noise, cast=ref_model.identity_cast):
    with torch.no_grad():
        return ref_model.denormalize(cfg, ref_model.generator(
            ref_model.nest(gen_w), noise, cfg, cast))


def reference_spikes(cfg, signals: torch.Tensor,
                     dtype=torch.float64) -> torch.Tensor:
    """Spikes of ``(n, T, C)`` signals, ``(n, T, C)`` booleans."""
    o = cfg["oasis"]
    n, T, C = signals.shape
    traces = signals.transpose(1, 2).reshape(n * C, T)
    s = ref_oasis.spikes(traces, o["g"], o["s_min"], o["threshold"], dtype)
    return s.reshape(n, C, T).transpose(1, 2)


def run(cell: dict, seed: int, seconds: float, traced: bool, started: float,
        device: str = "cuda") -> dict:
    from calciumgan_tpu_torch import generate
    from calciumgan_tpu_torch.ops import oasis_cuda

    cfg, mix = cell["config_data"], cell["traffic_data"]
    if cell["chips"] != 1:
        raise ValueError("the generate loop runs on one chip")
    device = torch.device(device)
    bs = mix["batch_size"]
    # float32 layers in full float32, as the serving CLI sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen_w = served_weights(cfg, device)
    config = program.port_config(cfg, mix, seed)
    noise_seed = inputs.derive(seed, 9)
    batches = generate.generate(config, program.generator_variables(gen_w),
                                num_samples=bs * 10 ** 6, batch_size=bs,
                                with_spikes=mix["with_spikes"],
                                seed=noise_seed, device=device)
    pick = np.random.default_rng([inputs.entropy(seed), 10])
    kept = {}

    def take(b: int) -> None:
        payload = next(batches)
        for r in pick.choice(bs, mix["kept_rows_per_batch"], replace=False):
            kept[(b, int(r))] = (payload["signals"][r].copy(),
                                 payload["spikes"][r].copy())

    take(0)
    print(f"setup first batch at {time() - started:.3f} s", file=sys.stderr,
          flush=True)
    for b in range(1, mix["warm_batches"]):
        take(b)
    b = mix["warm_batches"]
    launches_before = sum(oasis_cuda.launches.values())
    setup_s = time() - started
    t0 = perf_counter()
    n = 0
    while perf_counter() - t0 < seconds or n < 2:
        with torch.profiler.record_function("h100bench/generate_batch"):
            take(b)
        b, n = b + 1, n + 1
    window_s = perf_counter() - t0
    launches = sum(oasis_cuda.launches.values()) - launches_before
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    window = None
    if traced:  # steady batches after the window, under the profiler
        tracing = trace.Window(device)
        for b in range(b, b + mix["traced_batches"]):
            with torch.profiler.record_function("h100bench/generate_batch"):
                take(b)
        window = tracing.stop()
    batches.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    begin = time()
    numbers = check(cfg, mix, seed, noise_seed, gen_w, kept, device)
    print(f"reference {time() - begin:.3f} s", file=sys.stderr, flush=True)
    return {
        "attempted": n, "failed": 0, "numbers": numbers,
        "end_to_end": {"gen_samples_per_s": n * bs / window_s,
                       "setup_s": setup_s},
        "memory_peak_bytes": peak,
        "device_kind": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu", "count": 1,
        "context": {"batches": n, "window_s": window_s, "chips": 1,
                    "batch_least_s": work.generate_batch_seconds(cfg, bs),
                    "oasis_bytes_per_batch": work.oasis_bytes(
                        bs * cfg["num_channels"], cfg["sequence_length"]),
                    "oasis_launches": launches,
                    "traced_batches": mix["traced_batches"],
                    "traces": [window]},
    }


def check(cfg, mix, seed, noise_seed, gen_w, kept: dict, device) -> dict:
    """The compared numbers on ``checked_rows`` of the kept rows, drawn from
    the seed."""
    keys = sorted(kept)
    pick = np.random.default_rng([inputs.entropy(seed), 11])
    chosen = [keys[i] for i in sorted(pick.choice(
        len(keys), min(mix["checked_rows"], len(keys)), replace=False))]
    noise = noise_rows(noise_seed, mix["batch_size"], cfg["noise_dim"],
                       chosen, device)
    z = torch.stack([noise[k] for k in chosen])
    served = torch.from_numpy(np.stack([kept[k][0] for k in chosen])).to(
        device)
    spikes = np.stack([kept[k][1] for k in chosen])
    ref_signals = reference_signals(cfg, gen_w, z)
    ref_spikes = reference_spikes(cfg, served)
    return compare.generate_numbers(served.cpu().numpy(),
                                    ref_signals.cpu().numpy(),
                                    spikes, ref_spikes.cpu().numpy())
