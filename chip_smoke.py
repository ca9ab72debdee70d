#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and whole-recording spike
inference once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``calciumgan_tpu_torch/csrc`` with
``nvcc`` and runs five phases, printing one line of findings per phase:

1. device: the card, its power limit (``nvidia-smi``), the kernel build
   and the build of the float64 C++ redo of flagged traces;
2. kernel: the OASIS AR(1) CUDA kernel against its plain PyTorch version on
   the card, on seeded spiky traces at sl2048 with the production arguments
   and on the redo-bit edge cases, plus the dispatch's spikes against the
   float64 golden;
3. slice: ``calciumgan_tpu_torch.generate.generate`` at the flagship width
   (calciumgan, sl2048, 102 neurons, noise 32, units 64, kernel 24, stride
   2, layer_norm, bf16, normalize) with random weights from a seed, two
   batches of 1024 with spikes; the generator against its own float32 and
   CPU runs on a small input; spikes against the float64 golden; the
   kernel launch counter of that run;
4. timings on the card, each beside the card's name and power limit:
   generator, kernel and plain version (held against each other again at
   the main path's shape, one batch of generated traces), host redo, end
   to end, and the host-clock stages of one batch;
5. recordings: 2048 seeded synthetic recordings of 20,000 frames on the
   card. The long kernel (precise machine, production arguments) and the
   short kernel's precise mode against their plain versions, with the
   redo-bit and precise-band edge cases; the precise mode's public entry
   with its own launch count (no production path runs that mode); the
   dispatch's long route against
   the float64 golden (256 rows) and the C++ float64 kernel (all rows);
   ``python -m calciumgan_tpu_torch.dataset.spike_train_inference
   --device cuda`` in-process on four 102 x 20,000 pickles, with its
   launch counts, against the dispatch and the golden; the timings, beside
   the card's name and power limit.

Then the card's ``name, power.limit``, a ``{"kernels": [...]}`` line and, as
the last line, ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line; so does a machine without a CUDA device or a
directory without the port beside this script. JAX is never imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
T = 2048
G, S_MIN, THRESHOLD = 0.95, 0.55, 0.5
KERNEL_TRACES = 4096        # phase 2 batch (B >= 4096)
BATCH, BATCHES = 1024, 2    # phase 3 generation
GOLDEN_TRACES = 8192        # generated traces checked against float64
# phase 5: whole recordings (tools/check_long_kernel_tpu.py's size)
REC_TRACES, REC_T = 2048, 20000
REC_GOLDEN_TRACES = 256     # of them checked against the numpy golden
CLI_FILES, CLI_NEURONS = 4, 102
CLI_GOLDEN_ROWS = 32        # per file, against the numpy golden
ATOL = 1e-4                 # c, s: float32 pools vs float32 pools
GEN_F32_TOL = 1e-4          # generator on the card vs the CPU, float32
# the same in bfloat16: cuDNN and the CPU sum in other orders and round
# each layer's output to bfloat16, so one-ulp flips propagate; 4.5e-3 was
# measured on an H100 (NVIDIA H100 80GB HBM3, 700 W)
GEN_BF16_TOL = 1e-2


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def report(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls after one
    warm-up call, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flagship_config():
    """The paper recipe's architecture, as ``__graft_entry__`` builds it."""
    from calciumgan_tpu_torch.config import Config
    return Config(
        model="calciumgan", algorithm="wgan-gp", sequence_length=T,
        num_neurons=102, num_channels=102, signal_shape=(T, 102),
        noise_dim=32, num_units=64, kernel_size=24, strides=2, m=10,
        layer_norm=True, n_critic=5, normalize=True, signals_min=0.0,
        signals_max=1.0, mixed_precision=True, seed=SEED)


def golden_spikes(traces):
    """float64 OASIS spikes of (N, T) host traces by the numpy golden model,
    which shares no code with the dispatch's kernel or its C++ redo."""
    from calciumgan_tpu_torch.ops import golden
    return golden.golden_spikes(traces, g=G, s_min=S_MIN,
                                threshold=THRESHOLD)


def phase_device(root):
    import torch
    from calciumgan_tpu_torch.ops import oasis, oasis_cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    built = oasis_cuda.library()
    host = oasis.host_library()  # the float64 redo of flagged traces
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    report("phase 1 device", gpu=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count(), nvidia_smi=smi,
           torch=torch.__version__, cuda=torch.version.cuda,
           nvcc_build_s=round(built.seconds, 3),
           library=os.path.relpath(built.path, root), ptxas=ptxas,
           gxx_build_s=round(host.seconds, 3),
           host_library=os.path.relpath(host.path, root))
    torch.cuda.synchronize()
    return smi


def compare_kernel(y, long=False, **kw):
    """Kernel and plain version on the same CUDA traces; the findings. With
    ``long``, the long entry and its plain twin; ``plain_ms`` is the plain
    call's own time by CUDA events."""
    import torch
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    if long:
        kernel = oasis_cuda.oasis_ar1_long
        plain = oasis_torch.oasis_ar1_long_torch
    else:
        kernel, plain = oasis_cuda.oasis_ar1_cuda, oasis_torch.oasis_ar1_torch
    c, s, redo = kernel(y, **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    c_p, s_p, redo_p = plain(y, **kw)
    end.record()
    torch.cuda.synchronize()
    differ = redo != redo_p
    ok = (redo == 0) & (redo_p == 0)  # flagged lanes' output is unspecified
    err = 0.0
    if ok.any():
        err = max(float((c - c_p)[ok].abs().max()),
                  float((s - s_p)[ok].abs().max()))
    spikes_equal = bool(torch.equal(s[ok] > THRESHOLD, s_p[ok] > THRESHOLD))
    flags = redo.reshape(-1)
    return dict(lanes=int(redo.numel()), bits_differ=int(differ.sum()),
                differ_outside_bit2=int(((redo ^ redo_p) & 3).ne(0).sum()),
                unflagged=int(ok.sum()), flagged=int(redo.ne(0).sum()),
                max_abs_err=err,
                spikes_equal=spikes_equal,
                bit_frac={f"bit{b}": float(((flags >> b) & 1).float().mean())
                          for b in range(3)},
                plain_ms=start.elapsed_time(end),
                redo=[int(flags[0])], redo_plain=[int(
                    redo_p.reshape(-1)[0])])


def strip(found) -> dict:
    """:func:`compare_kernel`'s findings without the sample redo words."""
    return {k: v for k, v in found.items() if not k.startswith("redo")}


def check_agreement(found) -> None:
    """Kernel vs plain findings of :func:`compare_kernel` within bounds."""
    check(found["bits_differ"] <= 0.001 * found["lanes"],
          f"redo bits differ on {found['bits_differ']} of {found['lanes']}")
    check(found["differ_outside_bit2"] == 0, "redo bits 0/1 differ")
    check(found["max_abs_err"] <= ATOL, f"c/s err {found['max_abs_err']}")
    check(found["spikes_equal"], "binarised spikes differ")


def phase_kernel():
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops import golden
    from calciumgan_tpu_torch.ops import oasis as dispatch
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    host = golden.synth_ar1_traces(rng, KERNEL_TRACES, T)
    y = torch.from_numpy(host).to(dev)
    prod = dict(g=G, lam=0.0, s_min=S_MIN, depth=dispatch._DEPTH_LADDER[0],
                merge_attempts=dispatch._MERGE_BUDGET,
                flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD))
    main = compare_kernel(y, **prod)
    check_agreement(main)

    # redo-bit edge cases (tests/test_oasis_pallas.py:53-104)
    ramp = torch.linspace(0.0, 10.0, 64, device=dev)[None].repeat(3, 1)
    bit0 = compare_kernel(ramp, s_min=0.0, depth=8)
    dense = torch.from_numpy(golden.synth_ar1_traces(
        np.random.default_rng(SEED), 4, 128, rate=0.3)).to(dev)
    bit1 = compare_kernel(dense, s_min=S_MIN, merge_attempts=1)
    edge = torch.zeros((1, 64), device=dev)
    edge[0, 0], edge[0, 1] = 2.0, G * 2.0 + S_MIN + 1e-7
    bit2 = compare_kernel(edge, s_min=S_MIN, flag_tol=1e-5)
    for name, case, bit in (("bit0", bit0, 1), ("bit1", bit1, 2),
                            ("bit2", bit2, 4)):
        check(case["redo"] == case["redo_plain"] and case["redo"][0] & bit,
              f"{name} edge case: {case['redo']} vs {case['redo_plain']}")

    # the dispatch (ladder + float64 host redo) on the CUDA tensor
    spikes = dispatch.deconvolve_signals_host(y)
    golden = golden_spikes(host)
    mismatches = int((spikes != golden).sum())
    check(mismatches == 0, f"dispatch spikes: {mismatches} mismatches")
    torch.cuda.synchronize()
    report("phase 2 kernel", shape=[KERNEL_TRACES, T], production=prod,
           **strip(main),
           edge_bits={"bit0": bit0["redo"][0], "bit1": bit1["redo"][0],
                      "bit2": bit2["redo"][0]},
           dispatch_vs_golden=dict(golden="oasis_ref",
                                   mismatches=mismatches,
                                   spikes=int(golden.sum())))
    return main["max_abs_err"]


def generator_reference_check(config, params):
    """The generator on the card vs the same weights on the CPU, on a small
    input, in float32 (TF32 off) and in bfloat16."""
    import dataclasses

    import torch
    from calciumgan_tpu_torch.algorithms import gan
    from calciumgan_tpu_torch.generate import build_generator
    noise = torch.randn((2, config.noise_dim),
                        generator=torch.Generator().manual_seed(SEED + 1))
    errs, outs = {}, {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        cfg = dataclasses.replace(config, mixed_precision=bf16)
        outs[name] = [gan.generate(build_generator(cfg, params, dev),
                                   noise.to(dev)).cpu()
                      for dev in ("cuda", "cpu")]
        check(all(bool(torch.isfinite(o).all()) for o in outs[name]),
              f"{name} generator output not finite")
        errs[name] = float((outs[name][0] - outs[name][1]).abs().max())
    check(errs["f32"] <= GEN_F32_TOL, f"f32 generator err {errs['f32']}")
    check(errs["bf16"] <= GEN_BF16_TOL, f"bf16 generator err {errs['bf16']}")
    # what the bf16 bound is set against: float32 vs bfloat16, both on the CPU
    errs["f32_vs_bf16"] = float((outs["f32"][1] - outs["bf16"][1]).abs().max())
    return errs


def phase_slice(config, params):
    import numpy as np
    import torch
    from calciumgan_tpu_torch.generate import generate
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    ref_errs = generator_reference_check(config, params)

    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    start = time.perf_counter()
    payloads = list(generate(config, params, BATCH * BATCHES, BATCH,
                             with_spikes=True, seed=SEED, device="cuda"))
    seconds = time.perf_counter() - start
    launches, calls = oasis_cuda.launches["oasis_ar1"], oasis_torch.calls

    check(len(payloads) == BATCHES, f"{len(payloads)} batches")
    shape = (BATCH, T, config.num_channels)
    for p in payloads:
        check(p["signals"].shape == shape and p["signals"].dtype ==
              np.float32, f"signals {p['signals'].shape}")
        check(p["spikes"].shape == shape and p["spikes"].dtype == np.int8,
              f"spikes {p['spikes'].shape} {p['spikes'].dtype}")
    signals = np.concatenate([p["signals"] for p in payloads])
    spikes = np.concatenate([p["spikes"] for p in payloads])
    check(bool(np.isfinite(signals).all()), "non-finite signals")
    lo, hi = float(signals.min()), float(signals.max())
    check(config.signals_min <= lo and hi <= config.signals_max,
          f"signals outside [{config.signals_min}, {config.signals_max}]")
    check(set(np.unique(spikes).tolist()) <= {0, 1}, "spikes not in {0,1}")
    check(launches > 0, "the OASIS kernel was not launched")
    check(calls == 0, f"the plain OASIS version ran {calls} times")

    traces = np.ascontiguousarray(np.transpose(signals, (0, 2, 1))).reshape(
        -1, T)
    ours = np.transpose(spikes, (0, 2, 1)).reshape(-1, T)
    pick = np.random.default_rng(SEED).choice(len(traces), GOLDEN_TRACES,
                                              replace=False)
    golden = golden_spikes(traces[pick])
    mismatches = int((ours[pick] != golden).sum())
    check(mismatches == 0, f"{mismatches} spike mismatches vs float64")
    torch.cuda.synchronize()
    report("phase 3 slice", samples=len(signals), shape=list(shape),
           signals_range=[lo, hi], spikes=int(spikes.sum()),
           launches=launches, plain_calls=calls, seconds=round(seconds, 3),
           generator_vs_cpu=ref_errs, golden="oasis_ref",
           golden_traces=GOLDEN_TRACES, golden_spikes=int(golden.sum()),
           mismatches=mismatches)
    return launches


def e2e_stages(config, params, dev):
    """Host-clock seconds of each stage of one ``generate --spikes`` batch,
    as ``generate`` runs it, with a synchronize after each stage."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.algorithms import gan
    from calciumgan_tpu_torch.data.pipeline import reverse_preprocessing
    from calciumgan_tpu_torch.eval.spike_eval import deconvolve_traces
    from calciumgan_tpu_torch.generate import build_generator
    generator = build_generator(config, params, dev)
    noise = gan.get_noise(torch.Generator(device=dev).manual_seed(SEED),
                          BATCH, config.noise_dim, dev)
    stages, last = {}, time.perf_counter()

    def mark(name):
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name], last = now - last, now

    signals = reverse_preprocessing(config, gan.generate(generator, noise))
    mark("generator")
    signals.cpu().numpy()
    mark("signals_to_host")
    spikes = deconvolve_traces(signals.transpose(1, 2).contiguous())
    mark("deconvolve")
    np.ascontiguousarray(np.transpose(spikes, (0, 2, 1)))
    mark("spikes_transpose")
    return stages


def phase_timings(config, params, smi):
    import numpy as np
    import torch
    from calciumgan_tpu_torch.algorithms import gan
    from calciumgan_tpu_torch.generate import build_generator, generate
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    dev = torch.device("cuda")
    generator = build_generator(config, params, dev)
    noise = gan.get_noise(torch.Generator(device=dev).manual_seed(SEED),
                          BATCH, config.noise_dim, dev)
    gen_ms = cuda_ms(lambda: gan.generate(generator, noise), reps=10)

    traces = gan.generate(generator, noise).transpose(1, 2).contiguous()
    traces = traces.reshape(-1, T)  # (1024*102, 2048) generated traces
    kw = dict(g=G, lam=0.0, s_min=S_MIN, depth=dispatch._DEPTH_LADDER[0],
              merge_attempts=dispatch._MERGE_BUDGET,
              flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD))
    # the kernel vs its plain version at the main path's shape
    generated = compare_kernel(traces, **kw)
    check_agreement(generated)
    kernel_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_cuda(traces, **kw),
                        reps=5)
    plain_ms = generated["plain_ms"]  # the comparison's own call
    _, _, redo = oasis_cuda.oasis_ar1_cuda(traces, **kw)
    flags = redo.cpu().numpy()
    bit_frac = {f"bit{b}": float(((flags >> b) & 1).mean()) for b in range(3)}
    rows = traces[torch.from_numpy(np.nonzero(flags)[0]).to(dev)].cpu()
    dispatch._exact_spikes_host(rows[:1].numpy(), G, S_MIN, THRESHOLD)
    start = time.perf_counter()  # the C++ redo is built by now
    dispatch._exact_spikes_host(rows.numpy(), G, S_MIN, THRESHOLD)
    redo_s = time.perf_counter() - start

    for _ in generate(config, params, BATCH, BATCH, True, SEED, dev):
        pass  # warm-up of the whole path
    start = time.perf_counter()
    n = sum(len(p["signals"]) for p in generate(
        config, params, BATCH * BATCHES, BATCH, True, SEED, dev))
    e2e_s = time.perf_counter() - start
    stages = e2e_stages(config, params, dev)
    B = traces.shape[0]
    report("phase 4 timings", card=smi, kernel_vs_plain=strip(generated),
           generator_ms_per_batch=gen_ms,
           generator_samples_per_s=BATCH / gen_ms * 1e3,
           kernel_traces=B, kernel_ms=kernel_ms,
           kernel_traces_per_s=B / kernel_ms * 1e3, plain_ms=plain_ms,
           plain_traces_per_s=B / plain_ms * 1e3, redo_fraction=bit_frac,
           flagged=int((flags != 0).sum()), host_redo_s=redo_s,
           host_redo_threads=len(os.sched_getaffinity(0)),
           e2e_samples=n, e2e_s=e2e_s, e2e_samples_per_s=n / e2e_s,
           batch_stages_s=stages)
    torch.cuda.synchronize()
    return kernel_ms, plain_ms, generated["max_abs_err"]


def phase_recordings(smi):
    """Whole recordings: the long kernel and the precise machine against
    their plain versions, the dispatch's long route against the float64
    references, and the spike-inference CLI on seeded pickles."""
    import pickle
    import tempfile

    import numpy as np
    import torch
    from calciumgan_tpu_torch.dataset import spike_train_inference as cli
    from calciumgan_tpu_torch.ops import golden
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    host = golden.synth_ar1_traces(rng, REC_TRACES, REC_T)
    y = torch.from_numpy(host).to(dev)
    ladder = dispatch._long_ladder(REC_T)
    prod = dict(g=G, lam=0.0, s_min=S_MIN, depth=ladder[0],
                merge_attempts=dispatch._MERGE_BUDGET, precise=True,
                flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD, precise=True))

    # 1. the long kernel vs its plain version, production arguments
    long_main = compare_kernel(y, long=True, **prod)
    check_agreement(long_main)
    long_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_long(y, **prod), reps=3)

    # 2. redo-bit edge cases through the long and the precise short entry
    ramp = torch.linspace(0.0, 10.0, 160, device=dev)[None].repeat(3, 1)
    bit0 = compare_kernel(ramp, long=True, s_min=0.0, depth=16, precise=True)
    dense = torch.from_numpy(golden.synth_ar1_traces(
        np.random.default_rng(SEED), 4, 128, rate=0.3)).to(dev)
    bit1 = compare_kernel(dense, long=True, s_min=S_MIN, merge_attempts=1,
                          precise=True)
    # the precise band (tests/test_oasis_pallas.py:107-130): a 1e-5 margin
    # resolves unflagged and as the float64 golden does, 1e-8 sets bit 2
    edge = torch.zeros((1, 64), device=dev)
    edge[0, 0] = 2.0
    band = {}
    for name, margin in (("resolved", 1e-5), ("bit2", 1e-8)):
        edge[0, 1] = float(np.float32(G * 2.0 + S_MIN + margin))
        band[name] = compare_kernel(edge, g=G, s_min=S_MIN, flag_tol=1e-6,
                                    precise=True)
        if name == "resolved":
            _, s_edge, _ = oasis_cuda.oasis_ar1_cuda(
                edge, g=G, s_min=S_MIN, flag_tol=1e-6, precise=True)
            ref = golden_spikes(edge.cpu().numpy())
            check(np.array_equal((s_edge > THRESHOLD).cpu().numpy(),
                                 ref == 1),
                  "1e-5 margin: precise spikes differ from float64")
    for name, case, bit in (("bit0", bit0, 1), ("bit1", bit1, 2),
                            ("bit2", band["bit2"], 4)):
        check(case["redo"] == case["redo_plain"] and case["redo"][0] & bit,
              f"{name} edge case: {case['redo']} vs {case['redo_plain']}")
    check(band["resolved"]["redo"] == band["resolved"]["redo_plain"] == [0],
          f"1e-5 margin flagged: {band['resolved']['redo']}")

    # 3. the short kernel's precise mode at sl2048
    short = torch.from_numpy(golden.synth_ar1_traces(
        np.random.default_rng(SEED), KERNEL_TRACES, T)).to(dev)
    short_kw = dict(g=G, lam=0.0, s_min=S_MIN,
                    depth=dispatch._DEPTH_LADDER[0],
                    merge_attempts=dispatch._MERGE_BUDGET, precise=True,
                    flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD,
                                                precise=True))
    precise_main = compare_kernel(short, **short_kw)
    check_agreement(precise_main)
    precise_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_cuda(short, **short_kw),
                         reps=5)
    # no production path runs it (the JAX package calls it only for an
    # A/B), so its own path is the public entry, counted alone
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    _, _, redo_path = oasis_cuda.oasis_ar1(short, **short_kw)
    precise_launches = oasis_cuda.launches["oasis_ar1_precise"]
    check(precise_launches > 0 and oasis_torch.calls == 0,
          f"precise entry: {dict(oasis_cuda.launches)}, plain calls "
          f"{oasis_torch.calls}")
    check(int(redo_path.ne(0).sum()) == precise_main["flagged"],
          "precise entry flags differ from the compared kernel's")

    # 4. the dispatch's long route on the CUDA corpus
    before = oasis_cuda.launches["oasis_ar1_long_precise"]
    spikes = dispatch.deconvolve_signals_host(y)
    rungs = ladder[:oasis_cuda.launches["oasis_ar1_long_precise"] - before]
    start = time.perf_counter()
    spikes_again = dispatch.deconvolve_signals_host(
        torch.from_numpy(host).to(dev))
    dispatch_s = time.perf_counter() - start
    check(np.array_equal(spikes, spikes_again), "dispatch not repeatable")
    pick = np.sort(np.random.default_rng(SEED).choice(
        REC_TRACES, REC_GOLDEN_TRACES, replace=False))
    golden_ref = golden_spikes(host[pick])
    vs_golden = int((spikes[pick] != golden_ref).sum())
    check(vs_golden == 0,
          f"long dispatch: {vs_golden} mismatches vs oasis_ref")
    exact = dispatch._exact_spikes_host(host, G, S_MIN, THRESHOLD)
    vs_cxx = int((spikes != exact).sum())
    check(vs_cxx == 0, f"long dispatch: {vs_cxx} mismatches vs the C++ redo")
    _, _, redo = oasis_cuda.oasis_ar1_long(y, **prod)
    flagged = np.nonzero(redo.cpu().numpy())[0]
    start = time.perf_counter()
    dispatch._exact_spikes_host(host[flagged], G, S_MIN, THRESHOLD)
    redo_s = time.perf_counter() - start

    # 5. the CLI on seeded whole-recording pickles: the main path
    with tempfile.TemporaryDirectory() as tmp:
        recordings = []
        for i in range(CLI_FILES):
            sig = golden.synth_ar1_traces(np.random.default_rng(SEED + 1 + i),
                                          CLI_NEURONS, REC_T)
            recordings.append(sig)
            with open(os.path.join(tmp, f"rec{i}.pkl"), "wb") as f:
                pickle.dump({"signals": sig}, f)
        oasis_cuda.launches.clear()
        oasis_torch.calls = 0
        start = time.perf_counter()
        cli.main(["--input_dir", tmp, "--device", "cuda"])
        cli_s = time.perf_counter() - start
        cli_launches = dict(oasis_cuda.launches)
        cli_calls = oasis_torch.calls
        check(cli_launches.get("oasis_ar1_long_precise", 0) > 0,
              f"the long kernel was not launched: {cli_launches}")
        check(cli_calls == 0, f"the plain OASIS version ran {cli_calls} times")
        cli_golden = 0
        for i, sig in enumerate(recordings):
            with open(os.path.join(tmp, f"rec{i}.pkl"), "rb") as f:
                out = pickle.load(f)["oasis"]
            check(out.dtype == np.float32 and out.shape == sig.shape,
                  f"oasis {out.dtype} {out.shape}")
            check(set(np.unique(out).tolist()) <= {0.0, 1.0},
                  "oasis not in {0,1}")
            same = dispatch.deconvolve_signals_host(
                torch.from_numpy(sig).to(dev))
            check(np.array_equal(out, same.astype(np.float32)),
                  f"rec{i}: the CLI differs from deconvolve_signals_host")
            rows = np.sort(np.random.default_rng(SEED + i).choice(
                CLI_NEURONS, CLI_GOLDEN_ROWS, replace=False))
            cli_golden += int((out[rows] != golden_spikes(sig[rows])).sum())
        check(cli_golden == 0, f"CLI: {cli_golden} mismatches vs oasis_ref")
        one = torch.from_numpy(recordings[0]).to(dev)  # one recording
        cli_kernel_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_long(one, **prod),
                                reps=3)
        cli.main(["--input_dir", tmp, "--device", "cuda", "--clean"])
        for i in range(CLI_FILES):
            with open(os.path.join(tmp, f"rec{i}.pkl"), "rb") as f:
                check("oasis" not in pickle.load(f), "--clean kept oasis")
    torch.cuda.synchronize()

    report("phase 5 recordings", card=smi, shape=[REC_TRACES, REC_T],
           production=prod, long_vs_plain=strip(long_main),
           long_kernel_ms=long_ms,
           long_kernel_traces_per_s=REC_TRACES / long_ms * 1e3,
           long_plain_ms=long_main["plain_ms"],
           long_plain_traces_per_s=REC_TRACES / long_main["plain_ms"] * 1e3,
           edge_bits={"bit0": bit0["redo"][0], "bit1": bit1["redo"][0],
                      "bit2": band["bit2"]["redo"][0],
                      "resolved": band["resolved"]["redo"][0]},
           precise_short=dict(shape=[KERNEL_TRACES, T], **strip(precise_main),
                              kernel_ms=precise_ms,
                              entry_launches=precise_launches),
           dispatch=dict(rungs=list(rungs), ladder=list(ladder),
                         seconds_host_to_host=dispatch_s,
                         golden="oasis_ref", golden_traces=REC_GOLDEN_TRACES,
                         mismatches_vs_golden=vs_golden,
                         mismatches_vs_cxx_redo=vs_cxx,
                         spikes=int(spikes.sum()), flagged=len(flagged),
                         host_redo_s=redo_s),
           cli=dict(files=CLI_FILES, shape=[CLI_NEURONS, REC_T],
                    seconds=cli_s, seconds_per_recording=cli_s / CLI_FILES,
                    kernel_ms_per_recording=cli_kernel_ms,
                    launches=cli_launches, plain_calls=cli_calls,
                    golden_rows=CLI_FILES * CLI_GOLDEN_ROWS,
                    mismatches_vs_golden=cli_golden))
    err = max(long_main["max_abs_err"], bit0["max_abs_err"],
              bit1["max_abs_err"])
    precise_err = max(precise_main["max_abs_err"],
                      band["resolved"]["max_abs_err"])
    return dict(
        precise=dict(launches=precise_launches,
                     path=f"oasis_cuda.oasis_ar1(precise=True), "
                          f"{KERNEL_TRACES} x {T}",
                     max_abs_err=precise_err, ms=precise_ms,
                     plain_ms=precise_main["plain_ms"]),
        long=dict(launches=cli_launches.get("oasis_ar1_long", 0)
                  + cli_launches.get("oasis_ar1_long_precise", 0),
                  path="spike_train_inference --device cuda",
                  max_abs_err=err, ms=long_ms,
                  plain_ms=long_main["plain_ms"]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # float32 convolutions and matmuls in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import calciumgan_tpu_torch
    from calciumgan_tpu_torch import convert
    from calciumgan_tpu_torch.models import get_models
    check(os.path.dirname(os.path.dirname(os.path.abspath(
        calciumgan_tpu_torch.__file__))) == root,
        "calciumgan_tpu_torch is not the checkout's")

    smi = phase_device(root)
    max_err = phase_kernel()
    config = flagship_config()
    weights = get_models(config, rng=torch.Generator().manual_seed(SEED))
    params = convert.flax_generator_params(weights.state_dict())
    launches = phase_slice(config, params)
    kernel_ms, plain_ms, err = phase_timings(config, params, smi)
    max_err = max(max_err, err)
    recordings = phase_recordings(smi)
    jax_loaded = [m for m in ("jax", "flax", "optax") if m in sys.modules]
    check(not jax_loaded, f"imported {jax_loaded}")

    print(smi)
    source = "calciumgan_tpu_torch/csrc/oasis_ar1.cu"
    print(json.dumps({"kernels": [
        {"name": "oasis_ar1", "route": "cuda", "source": source,
         "replaces": "calciumgan_tpu/ops/oasis_pallas.py:599",
         "launches": launches, "path": "generate --spikes",
         "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": "oasis_ar1_precise", "route": "cuda", "source": source,
         "replaces": "calciumgan_tpu/ops/oasis_pallas.py:599",
         **recordings["precise"]},
        {"name": "oasis_ar1_long", "route": "cuda", "source": source,
         "replaces": "calciumgan_tpu/ops/oasis_pallas.py:509",
         **recordings["long"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
