#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path, whole-recording spike
inference, dataset preparation, training, evaluation, the DG experiments,
the conv2d model, BatchNorm, the in-graph ``deconvolve_signals``, the
sweep, data-, model- and time-parallel training and the evaluation of a
long-sequence run once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 14   # phases 1 and 14 alone
    python3 chip_smoke.py --phase 15   # phases 1 and 15 alone
    python3 chip_smoke.py --phase 15-nccl  # phases 1 and 15 (c) alone
    python3 chip_smoke.py --phase 16   # phases 1 and 16 alone
    python3 chip_smoke.py --phase 17   # phases 1 and 17 (four GPUs)

Builds the port's CUDA kernel from ``calciumgan_tpu_torch/csrc`` with
``nvcc`` and runs sixteen phases, printing one line of findings per phase.
Every comparison of the kernel with its plain PyTorch version is bit for
bit: ``c``, ``s`` and the redo bits equal on every lane, flagged and
overflowed lanes included. Each launch's ring storage (shared or device
memory, ``oasis_cuda.launch_plan``) is in its launch counter's key, and
every (machine, storage) pair the plan can choose is compared. The plain
version's time is set by frames and launches, not rows, so the classic
kernel's launches at the production arguments (phase 2's rungs and every
path's sampled or evaluated traces) are held to it in one plain call a
(frames, depth), row for row, on the ``twins`` line once the phases have
run (``flush_twins``):

1. device: the card, its power limit (``nvidia-smi``), the kernel build
   and the build of the float64 C++ redo of flagged traces;
2. kernel: the OASIS AR(1) CUDA kernel against its plain PyTorch version on
   the card, on seeded spiky traces at sl2048 with the production arguments
   at every rung of the depth ladder (64, 160, 256: shared-memory rings)
   and at depth 1024 (device-memory rings) (on the twins line), and on the
   redo-bit edge cases, plus the dispatch's spikes against the C++ float64
   kernel (all 4096 traces) and the numpy float64 golden (the first 1024);
   run beside phase 5's spawned comparisons, as are phase 3's checks;
3. slice: ``calciumgan_tpu_torch.generate.generate`` at the flagship width
   (calciumgan, sl2048, 102 neurons, noise 32, units 64, kernel 24, stride
   2, layer_norm, bf16, normalize) with random weights from a seed, two
   batches of 1024 with spikes; the generator against its own float32 and
   CPU runs on a small input; spikes of 4096 sampled traces against the
   C++ float64 kernel and of 1024 of them against the numpy float64
   golden; the kernel launch counter of that run;
4. timings on the card, each beside the card's name and power limit:
   generator, kernel and plain version (held against each other again at
   the main path's shape, one batch of generated traces), host redo, end
   to end, and the host-clock stages of one batch;
5. recordings: 2048 seeded synthetic recordings of 20,000 frames on the
   card. The long kernel (precise machine, production arguments, depth 512:
   shared-memory rings) and the short kernel's precise mode against their
   plain versions, the long kernel at depths 1024 and 2048 (device-memory
   rings) on 256 traces of 8192 frames, with the redo-bit and precise-band
   edge cases; the precise mode's public entry
   with its own launch count (no production path runs that mode); the
   dispatch's long route against
   the float64 golden (256 rows) and the C++ float64 kernel (all rows)
   (every time taken first, on an idle card; the long kernel's
   comparisons with its plain version, minutes at these frames, then run
   in spawned processes, one a case, and the numpy golden in more, while
   the script runs phase 2, phase 3's checks, phase 10's step on the card
   against the CPU and the float64 checks);
   ``python -m calciumgan_tpu_torch.dataset.spike_train_inference
   --device cuda`` in-process on four 102 x 20,000 pickles, with its
   launch counts, against the dispatch and the golden; the timings, beside
   the card's name and power limit;
6. training: a flagship-shaped TFRecord dataset (512 + 128 rows of 2048 x
   102 seeded synthetic calcium, written by the port's writer) trained by
   ``python -m calciumgan_tpu_torch.main --save_generated all`` in-process
   at the flagship recipe (wgan-gp, batch 128, units 64, kernel 24, m 10,
   layer_norm, bf16, n_critic 5) for 2 epochs with ``--profile``, then
   resumed to 3: the epochs, ``global_step``, checkpoints, finite losses,
   the dataset on the card, the validation cache and the three epoch files
   (128 rows each) with the seconds saving adds to a validation pass, the
   sampling epochs' OASIS launches (``oasis_ar1/shared`` only, no plain
   calls) and their spikes against the float64 golden, the
   newest checkpoint served through ``generate.generate``; one full-width
   WGAN-GP step (batch 8, n_critic 2) on the card against the CPU from one
   state and the same draws, in float32 and bfloat16; the step's time at
   batch 128 by CUDA events (critic and generator steps), its FLOPs by
   ``FlopCounterMode`` against the bf16 peak, steps/s over an epoch, the
   profile window's device-busy share, ``sample_and_plot`` and a checkpoint
   save, beside the card's name and power limit; ``train.train_epoch`` on
   one state with each of its batch sources: ``DeviceStore``,
   ``HostBatches`` through ``DevicePrefetcher`` and ``HostBatches`` inline
   on the training thread, ``PREFETCH_EPOCHS`` timed epochs a mode (steps/s
   median and spread, and the device-busy share of one more epoch under
   ``torch.profiler``), after holding an epoch's prefetched batches to the
   inline ones bit for bit and checking that they were copied on a side
   stream;
7. dataset preparation: one of phase 5's 102 x 20,000 pickles, with the
   ``oasis`` key the spike-inference CLI wrote, through ``python -m
   calciumgan_tpu_torch.dataset.generate_tfrecords`` in-process
   (``--sequence_length 2048 --stride 28 --normalize --validation_size
   128``), loaded back by the port's ``get_datasets``: the counts, the
   shapes, and windows against the recording; the seconds;
8. evaluation at the paper's size: a run directory of 1000 trials x 2048 x
   102 (recorded side: seeded synthetic traces with spikes by the C++
   float64 kernel; generated side: ``generate.generate`` on phase 6's
   newest checkpoint) written through ``io.cache_validation_set`` and
   ``io.save_fake_signals`` and evaluated by ``python -m
   calciumgan_tpu_torch.compute_metrics --device cuda`` in-process: finite
   KLs in ``metrics.json``, the epoch file's spikes against the float64
   golden (1024 traces) and the C++ float64 kernel (all 102,000), the OASIS
   launches of that run (``oasis_ar1/shared`` only, no plain calls), the
   statistics on the card against the CPU on 32 trials, the seconds per
   epoch file by stage and statistic, Victor-Purpura on 16 trials, and
   ``compute_metrics --all_epochs`` on phase 6's own run. Every KL printed
   is of seeded synthetic data and a generator of three epochs: it says
   nothing of real recordings;
9. the DG experiments: ``python -m
   calciumgan_tpu_torch.dataset.generate_dg_data --device cuda`` in-process
   on one of phase 5's pickles (100 x 20,000 out; its 0.02 spikes a frame
   leave the DG no spike, since the CLI hands the sampler the data's
   covariance where it takes a correlation matrix, as the JAX package and
   the reference do) and on a dense seeded recording with correlated
   neurons (spikes by the spike-inference CLI): spikes binary, each
   neuron's firing probability against ``Phi(mu / sigma)``, ``ar1_filter``
   on the card against the CPU and a float64 loop, the seconds by stage;
   the full fit the CLI never calls (4,950 pairs, timebins 1 and 64
   timebins x 200 trials) on the card against the CPU to 1e-9 (the
   time-varying one on the first 32 neurons' 496 pairs), and the
   moments of 10**6 draws from a sampler built on the fitted matrix;
   ``generate_tfrecords --is_dg_data`` (561 windows of 2048 x 100), ``main``
   at the flagship recipe with ``--ema 0.999 --device_store off
   --save_generated last`` for 2 epochs (the EMA side-car differs from the
   raw generator and is what the epoch file holds and ``generate`` serves;
   batches come from the host; the sampling epochs' spikes against the
   float64 golden), ``compute_dg_metrics --device cuda`` (finite MAE, RMSE
   and MAPE, ``oasis_ar1/shared`` launches only; the epoch file's spikes
   against the float64 golden on 128 traces and the C++ float64 kernel on
   all 6,400; the statistics on the card against the CPU; the whole CLI
   against ``--device cpu`` on a copy of the run's first 5 trials without
   spikes, which the CPU deconvolves for itself: equal spikes, the
   dictionary within 1e-5); ``generate_surrogate_data --device cuda`` at
   its defaults (2 x 10**6 sequences of 6 x 2), ``main --model mlp
   --algorithm gan`` for 3 epochs with its sampled spikes against the
   golden and its ``generated.pkl``, and one vanilla-GAN step of the mlp
   model on the card against the CPU. The kernel is held to its plain
   version bit for bit at each of the three shapes these paths give it:
   100 x 2048 (a DG sampling epoch), 6,400 x 2048 at every rung the CLI
   climbed, and 2 x 6 (an mlp sampling epoch: fewer frames than a ring is
   deep). Every error printed is of seeded synthetic data and generators
   of a few epochs.
10. conv2d: one of phase 5's recordings (its 102 rows the neurons) through
   ``generate_tfrecords --conv2d`` (129 windows of 2048 x 102 x 1), ``main
   --model calciumgan2d`` at the conv2d recipe (wgan-gp, batch 64, units
   64, kernel 24, m 10, n 2, layer_norm, bf16, n_critic 5) for 1 epoch
   (one step) with ``--save_generated last`` and rerun (it resumes, finds
   the run done and trains nothing), ``compute_metrics --device cuda`` on
   the run and ``generate --spikes`` from its newest checkpoint: finite
   losses and KLs, the epoch file's shape (64, 2048, 102),
   ``oasis_ar1/shared`` launches only, the kernel equal to its plain
   version at each (shape, depth) those launches ran, the sampled,
   epoch-file and served spikes against the float64 references; one
   full-width 2-D WGAN-GP step (256 frames, batch 2, n_critic 1) on the
   card against the CPU in float32 and bfloat16 (made beside phase 5's
   spawned comparisons); the step at batch 64 by CUDA events, its FLOPs,
   share of the bf16 bound and top kernels by ``torch.profiler``, and each
   layer's convolutions alone (the generator's also as
   ``F.conv_transpose2d``);
11. BatchNorm: ``main --batch_norm --algorithm gan --ema 0.999`` at the
   flagship recipe on phase 6's records for 2 epochs: its sampling epochs'
   launches and spikes, the stored running statistics (finite, moved from
   0 and 1), ``generate`` serving the EMA parameters with them (equal to
   ``GAN.sample``, unlike mean 0 and variance 1), and one BatchNorm step
   on the card against the CPU (losses, gradients, running statistics);
12. the in-graph API: ``ops.oasis.deconvolve_signals`` on phase 4's
   generated traces (104,448 x 2048) on the card, with its launches (one
   ``oasis_ar1/shared``, no plain call), flagged rows and host-to-host
   seconds, its spikes equal to the kernel's where no redo bit rose and to
   ``oasis_ar1_while``'s where one did (and counted against the host
   dispatch, which recomputes borderline rows in float64); the kernel at
   the API's setting (depth 128, merge budget 4, no band) against its
   plain version bit for bit and timed; the redo path forced by depth 8 on
   256 rows: the while machine sees the flagged rows and no other, and
   they take its spikes; ``oasis_ar1_while`` on the card against the CPU
   and the float64 golden (differences reported, not bounded: a float32
   decision within rounding of its margin may go either way), timed at 64
   and 1024 rows;
13. the sweep: ``python -m calciumgan_tpu_torch.search --device cuda``
   in-process with two points of the default grid (noise_dim 4 and 16,
   units 32, kernel 4, phase shuffle 1) on phase 6's records, batch 64, 2
   epochs: two ``results.jsonl`` lines with finite metrics, the
   ``_hparams_`` events, each experiment's sampling-epoch launches and
   spikes against the float64 golden; a rerun that skips both ("already
   exists") and leaves the results as they were; ``--summarize``;
   ``--parallel 2`` refused on one GPU;
14. data parallelism on one card (NCCL puts no two ranks on one GPU): two
   ranks on ``cuda:0`` over gloo, started by the library's launcher: the
   flagship step (batch 128, 64 rows a rank) at learning rate 0 in
   float32 and bfloat16 against the one-process step on the same draws
   (losses and each net's largest gradient difference), again on the
   layout ``--dcn_slices 2 --data_parallelism 1`` makes (two slices of one
   rank, with its 7 all-reduces a step), then ``main
   --data_parallelism 2 --save_generated last`` for 2 epochs on phase 6's
   records: the replicas equal bit for bit, one writer (``hparams.json``,
   checkpoints, events), two epoch-file shards of 64 rows, OASIS launched
   in rank 0's sampling epochs only, the kernel equal to its plain version
   on the last sampled traces and their spikes to the float64 golden, the
   ranks' steps/s beside phase 6's one process (gloo through the host: no
   speed figure); one rank through ``--distributed`` in a ``torchrun``
   environment of world size 1 over NCCL for an epoch, with its collective
   calls counted; ``--data_parallelism 2 --device cuda`` refused on one
   GPU (on a machine of several, the same run over NCCL on every GPU and
   on one instead, and the flagship step loop timed on one GPU without a
   group and on every GPU over NCCL, launched in the order 1, P, P, 1,
   each launch timing ``DP_SCALING_WINDOWS`` windows of
   ``DP_SCALING_STEPS`` steps after ``DP_SCALING_WARMUP`` through phase
   15's step loop: the median steps/s of each, their spread and the
   speed-up);
15. model and time parallelism on one card, two gloo ranks on ``cuda:0``
   each: (a) ``main --model_parallelism 2 --save_generated last`` at the
   flagship recipe on phase 6's records for 2 epochs: the two
   sequence-sized Dense layers' shards (the critic head's 10,240 input
   rows and the generator projection's 1024 output columns a rank), the
   flagship step at learning rate 0 against the one-process step in
   float32 and bfloat16 with its model-axis collectives (18 all-reduces
   and 17 all-gathers), the mlp's step likewise (wgan-gp, dropout 0.2, the
   surrogate set's widths at batch 64: the critic's first layer cut by
   output columns, its input taking gradients), the whole state equal bit
   for bit on both ranks,
   one writer, a checkpoint of whole tensors that ``generate.generate``
   serves, ``oasis_ar1/shared`` in rank 0's sampling epochs only, held to
   its plain version on the last sampled traces, their spikes against the
   float64 golden; (b) ``main --time_parallelism 2 --save_generated
   last`` on 32 + 16 seeded windows of 102 x 16,384 frames at batch 16:
   the step at m 0 against the one-process standard step at 16,384 frames
   (float32 losses and gradients; again with cuDNN's deterministic
   algorithms on both sides), 2 epochs at m 10 whose epoch file holds
   whole 16,384-frame rows, ``oasis_ar1_long_precise`` in rank 0's
   sampling epochs (depth 384 with shared-memory rings, deeper rungs with
   device-memory rings where a batch climbs), timed and held to its plain
   version at every rung the dispatch climbs on the last 102 x 16,384
   sampled traces, their spikes against the golden with its seconds a
   trace (the comparisons in
   spawned processes, one a rung, since the plain version takes one to
   two minutes a rung at these frames: on one GPU they run beside phase
   14 and (a), whose lines say so; on several, they end before phase 14).
   (c) On a machine of four GPUs or more (``--phase 15-nccl`` runs (c)
   alone), data 2 x model 2, time 4, data 2 x time 2 and model 4 over
   NCCL, one launch each: the step against the one process, then the step
   loop with every rank's peak memory against one GPU, a line each as it
   ends; the recipe with BatchNorm at data 2 x model 2: its step against
   the one process, its running statistics equal on every rank; then the
   model-parallel run over NCCL, then the one-GPU loop again;
16. a long-sequence run evaluated: a run directory of 160 trials x 16,384
   frames x 102 (recorded side seeded synthetic calcium drawn on the card,
   with spikes by the C++ float64 kernel; generated side
   ``generate.generate`` on phase 15 (b)'s time-parallel checkpoint, or
   seeded random weights under ``--phase 16``), so that ``deconvolve_file``
   takes one full chunk of 16,320 traces a launch, through
   ``compute_metrics --device cuda --covariance`` on an idle card:
   ``metrics.json``, the long kernel's launches by rung and ring storage,
   the seconds by stage and statistic,
   the flag share per bit and peak memory; the long kernel on the whole
   chunk at every rung of the 16,384-frame ladder (384 shared, 768 and
   1536 device), timed, its flags asking for exactly the rungs climbed,
   256 rows of each launch held to the plain version bit for bit in
   spawned processes (which run beside phases 14 and 15 (a) in the whole
   script); every spike of the file against the C++ float64 kernel, 256
   traces against the numpy golden (spawned); each statistic's seconds
   and peak memory over every trial, and the card against the CPU on 8
   trials (Victor-Purpura on 1 trial of 16 neurons; the covariance held
   per pair to the correlation's bound times sigma_i sigma_j); a resumed
   ``deconvolve_file`` (one staged chunk) ending with the same spikes.

``--phase 17`` (four GPUs, not in the whole run): ``main --dcn_slices 2
--data_parallelism 2`` at the flagship recipe for 2 epochs over NCCL on
its own training set (every replica equal bit for bit, the step within
phase 14's bounds of the one process with the data axis's 7 all-reduces,
the step loop against one GPU), then ``python -m
calciumgan_tpu_torch.search --parallel 2 --device cuda`` over phase 13's
grid: two workers of two GPUs, each experiment data-parallel over its
slice (both sessions' metrics finite, each run's ranks equal bit for bit,
OASIS in each slice's first rank only, the seconds per experiment).

Then the card's ``name, power.limit``, a ``{"kernels": [...]}`` line (each
kernel's time, its plain version's, its bound, and its launches on its
paths, by ring storage and by path) and, as
the last line, ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line; so does a machine without a CUDA device or a
directory without the port beside this script. JAX is never imported.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
T = 2048
G, S_MIN, THRESHOLD = 0.95, 0.55, 0.5
KERNEL_TRACES = 4096        # phase 2 batch (B >= 4096)
BATCH, BATCHES = 1024, 2    # phase 3 generation
# phases 2-3: traces checked against the C++ float64 kernel, and the first
# of them against the numpy float64 golden (~0.02 s a 2048-frame row on the
# card's host: 1024 of 4096 since PR 8, to keep the script's time)
GOLDEN_TRACES = 4096
NUMPY_GOLDEN_TRACES = 1024
# phase 5: whole recordings (tools/check_long_kernel_tpu.py's size)
REC_TRACES, REC_T = 2048, 20000
REC_GOLDEN_TRACES = 256     # of them checked against the numpy golden
REC_GOLDEN_WORKERS = 2      # spawned processes that golden is split over
DEVICE_RING_TRACES = 256    # traces for the device-memory ring comparisons
DEVICE_RING_T = 8192        # frames of the long kernel's device-ring cases
CLI_FILES, CLI_NEURONS = 4, 102
CLI_GOLDEN_ROWS = 32        # per file, against the numpy golden
GEN_F32_TOL = 1e-4          # generator on the card vs the CPU, float32
# the same in bfloat16: cuDNN and the CPU sum in other orders and round
# each layer's output to bfloat16, so one-ulp flips propagate; 4.5e-3 was
# measured on an H100 (NVIDIA H100 80GB HBM3, 700 W)
GEN_BF16_TOL = 1e-2
# phase 6: the flagship training set (512 + 128 rows of 2048 x 102, 1.07 GB
# of records) and the card-vs-CPU bounds of one full-width WGAN-GP step at
# learning rate 0, each about 3x the largest error measured on an H100
# (NVIDIA H100 80GB HBM3, 700 W): float32 with TF32 off, losses 4.8e-6
# absolute (discriminator; 2.4e-5 relative on a generator loss of 6.5e-3)
# and gradients 1.1e-3 of the net's largest (cuDNN's algorithms sum and
# transform in other orders than the CPU's); bfloat16, losses 9.2e-4
# absolute on 5.97 and gradients 0.036 of the net's largest. float32 vs
# bfloat16 on the CPU differ by 5.3e-3 in the critic loss (outside the
# bf16 loss bound) and by 0.068 in the gradients (inside the bf16
# gradient bound: the CPU tests' 1e-4 bound holds the rounding points)
TRAIN_ROWS, VAL_ROWS = 512, 128
# phase 7: the windows generate_tfrecords cuts from a 20,000-frame recording
PREP_STRIDE = 28
# phase 8: the paper's validation set (dataset/generate_tfrecords.py's
# default --validation_size) at the flagship width
EVAL_TRIALS, EVAL_NEURONS = 1000, 102
EVAL_GOLDEN_TRACES = 1024   # of its traces checked against the numpy golden
EVAL_CPU_TRIALS = 32        # statistics on the card against the CPU
EVAL_VP_TRIALS = 16         # Victor-Purpura runs on these only
# the statistics on the card against the same functions on the CPU: firing
# rates are sums of 0/1 over one duration (exact); correlations are float32
# products of 170 bin counts (the CPU tests' bound, NaN masks equal); a van
# Rossum d**2 is a difference of float32 sums over 2048 frames that reach
# thousands on a noisy generator's dense trains, summed in another order on
# the card, so its bound is relative to the largest d**2; a trial's KL may
# move by a bin count where a value sits within rounding of a bin edge, so
# the bound is on the mean KL over the trials
STAT_CORR_TOL = 1e-5
STAT_VR_RTOL = 1e-5
STAT_KL_TOL = 1e-3
# phase 9: the DG experiments. The dense recording (0.3 spikes a frame, a
# shared source of weight 0.7 in every neuron) is what leaves the DG data
# CLI spikes to sample; 561 windows of 2048 at stride 32, of which 64
# validate; the surrogate set at its CLI's defaults
DG_DENSE_RATE, DG_SHARED = 0.3, 0.7
DG_STRIDE, DG_VAL_ROWS = 32, 64
DG_TIMEBINS, DG_TRIALS = 64, 200   # the time-varying fit's layout
DG_CPU_NEURONS = 32                # of it fitted on the CPU too (496 pairs)
DG_FIT_SAMPLES = 10**6             # drawn from the fitted sampler
DG_GOLDEN_TRACES = 128             # of the epoch file, against the golden
DG_CPU_TRIALS = 5                  # compute_dg_metrics' --num_trials
SURROGATE_SAMPLES, MLP_EPOCHS = 2 * 10**6, 3
# a neuron's sampled firing probability against Phi(mu / sigma), in
# binomial standard deviations of its 20,000 frames
DG_RATE_SIGMAS = 6
# ar1_filter on the card against the CPU and a float64 loop: the CPU tests'
# bound against the JAX package (calcium of at most ~20)
AR_FILTER_TOL = 1e-5
# the fitted correlation matrix on the card against the CPU: the float64
# exp differs by an ulp, 60 bisection trips leave a bracket of 2e-18
DG_FIT_TOL = 1e-9
# moments of 10**6 draws from the fitted sampler against the data's: 4.5
# standard deviations of the largest entry's estimate (0.5 / 1000) over
# 5050 entries, twice
DG_MOMENT_TOL = 5e-3
STEP_F32_LOSS_RTOL, STEP_F32_LOSS_ATOL = 1e-5, 1e-6
STEP_F32_GRAD_TOL = 3e-3      # of the net's largest gradient moment
STEP_BF16_LOSS_RTOL, STEP_BF16_LOSS_ATOL = 5e-4, 2e-4
STEP_BF16_GRAD_TOL = 0.1      # of the net's largest gradient moment
# the generator's BatchNorm running statistics after a step, card vs CPU
# (absolute; a net without BatchNorm has none): measured 6.0e-8 and 8.3e-7
# after phase 11's GAN step on an H100 (NVIDIA H100 80GB HBM3, 700 W)
STEP_F32_STATS_TOL, STEP_BF16_STATS_TOL = 1e-6, 1e-5
# phase 11's float32 gradients, card vs CPU, of the net's largest moment:
# a BatchNorm over the step's 8 rows divides by their standard deviation,
# so the devices' summation orders show more than in phase 6's step
# (measured 2.3e-3 and 2.8e-3 in two calls on an H100, NVIDIA H100 80GB
# HBM3, 700 W)
BN_STEP_F32_GRAD_TOL = 1e-2
# phase 10: conv2d. Phase 5's recording with two rows in front (a
# recording's first two rows are not neurons), so its 102 rows are the
# neurons: 129 windows of 2048 at stride 140, 65 to train (one batch of 64:
# a step of the recipe takes seconds) and 64 to validate; the epoch files'
# spikes against the numpy golden on these many traces
CONV2D_STRIDE, CONV2D_VAL_ROWS, CONV2D_BATCH = 140, 64, 64
# its run: one epoch of one 22 s step, then a rerun that resumes from its
# checkpoint and finds it done
CONV2D_EPOCHS = 1
CONV2D_GOLDEN_TRACES = 128
CONV2D_SERVED = 16          # generate --spikes samples
# the full-width 2-D step on the card against the CPU, cut to 256 frames,
# batch 2 and n_critic 1 to bound the CPU's time
STEP2D_T, STEP2D_B = 256, 2
# phase 6's bounds, but a bfloat16 gradient may also differ by 3 times the
# CPU's own float32-vs-bfloat16 distance: the 2-D critic's largest moment is
# its last convolution's bias, a sum over real and fake rows that cancels
# and that bfloat16 keeps only as rounding (measured on an H100, NVIDIA
# H100 80GB HBM3, 700 W: card vs CPU 0.269 of it where the CPU's own two
# precisions differ by 0.156, 1.73 times)
STEP2D_BOUNDS = dict(bf16_grad_gap=3.0)
# phase 12: the in-graph API on phase 4's generated traces. Its redo path
# forced by depth 8 on these rows; oasis_ar1_while on the card against the
# CPU on these rows, the first of them against the float64 golden; the
# while machine timed at these row counts
FORCED_ROWS = 256
WHILE_CPU_ROWS, WHILE_GOLDEN_ROWS = 1024, 256
WHILE_TIMED_ROWS = (64, 1024)
# phase 13: two points of search.DEFAULT_GRID on phase 6's records, cut in
# depth to 2 epochs
SWEEP_GRID = {"noise_dim": [4, 16], "num_units": [32], "kernel_size": [4],
              "phase_shuffle": [1]}
SWEEP_EPOCHS = 2
# phase 6's batch sources: timed training epochs a mode (4 steps each)
PREFETCH_EPOCHS = 3
# phase 14: two gloo ranks on one card, the flagship batch split between them
DP_RANKS, DP_BATCH, DP_EPOCHS = 2, 128, 2
DP_TIMEOUT_S = 300
# a data-parallel WGAN-GP step's collectives at n_critic 5, slices folded
# into the data axis: one gradient all-reduce a net update (5 critic, 1
# generator) and one of the logs
DP_STEP_CALLS = {"all_reduce": 7}
# phase 17 (four GPUs): main --dcn_slices 2 --data_parallelism 2, and the
# sweep's --parallel 2, two GPUs a worker
DCN_SLICES, DCN_DATA, SWEEP_PARALLEL = 2, 2, 2
# phase 15: model and time parallelism, two gloo ranks on one card each:
# the flagship recipe with its two sequence-sized Dense layers sharded
# (MP_SHARDS a rank, in the port's (out, in) layout), and the same widths
# on 32 + 16 seeded windows of 16,384 frames at batch 16 (16 x 16,384
# frames a step, as many as the recipe's 128 x 2048; w0 512, a deepest
# shard of 256 frames at 4 time ranks), their frames split between ranks;
# 32 training rows, not 64, keep the script's time
MP_RANKS = TP_RANKS = 2
LC_T, LC_TRAIN_ROWS, LC_VAL_ROWS, LC_BATCH = 16384, 32, 16, 16
PAR_EPOCHS, PAR_TIMEOUT_S = 2, 600
MP_SHARDS = {"generator/dense_0.weight": (1024, 32),
             "generator/dense_0.bias": (1024,),
             "discriminator/dense.weight": (1, 10240)}
# the same at model 4 (phase 15 (c), four GPUs)
MP4_SHARDS = {"generator/dense_0.weight": (512, 32),
              "generator/dense_0.bias": (512,),
              "discriminator/dense.weight": (1, 5120)}
# a flagship step's model-axis collectives at model 2: the input
# projection's noise takes no gradient, so its column shards add no
# all-reduce
MP_STEP_CALLS = {"all_reduce": 18, "all_gather": 17}
# phase 15 (a)'s mlp at model 2: the surrogate set's widths (6 frames x 2
# neurons, noise 32, units 32, dropout 0.2) under WGAN-GP at the surrogate
# run's batch; the critic's first layer is cut by output columns, its input
# taking the penalty's and the generator's gradients
MLP_FIELDS = dict(model="mlp", sequence_length=6, num_neurons=2,
                  num_channels=2, signal_shape=(6, 2), num_units=32,
                  noise_dim=32, dropout=0.2)
MLP_BATCH = 64
MLP_MP_SHARDS = {"discriminator/dense_0.weight": (64, 2),
                 "discriminator/dense_0.bias": (64,),
                 "discriminator/dense_4.weight": (1, 96)}
# phase 15 on four GPUs: the step loop's steps a timed window, windows a
# launch, and untimed steps before them
PAR_LOOP = PAR_LOOP_STEPS, PAR_LOOP_WINDOWS, PAR_LOOP_WARMUP = 15, 3, 3
# phase 14 on several GPUs: steps a timed window, windows a launch, and
# untimed steps before them
DP_SCALING = DP_SCALING_STEPS, DP_SCALING_WINDOWS, DP_SCALING_WARMUP = (
    50, 4, 10)
# phase 16: a long-sequence run evaluated by compute_metrics. One full chunk
# of deconvolve_file on the card (16,384 // 102 = 160 trials, 16,320 traces
# a launch) at phase 15 (b)'s frames; of each rung's launch on the whole
# chunk, these rows are held to the plain version (one to two minutes a
# rung at these frames, whatever the rows); of the epoch file's traces,
# these against the numpy float64 golden (0.15-0.19 s a trace), split over
# spawned processes; the statistics on the card against the CPU on these
# trials (Victor-Purpura on fewer, of fewer neurons: its DP grows with the
# square of the spike count and of the neurons; on the H100 machine's host
# the CPU took 105 s for 2 trials of 102 neurons at up to 471 spikes a
# train, 88.7 s for 2 trials of 32 neurons at up to 2478, phase 15 (b)'s
# generator's, and 15.6-19.1 s for 2 trials of 16); generated in batches
# of LE_BATCH
LE_TRIALS, LE_NEURONS, LE_T, LE_BATCH = 160, 102, LC_T, 32
LE_PLAIN_ROWS = 256
LE_GOLDEN_TRACES, LE_GOLDEN_WORKERS = 256, 2
LE_CPU_TRIALS, LE_VP_TRIALS, LE_VP_NEURONS = 8, 1, 16
# the H100 SXM data sheet's dense bfloat16 tensor-core rate
BF16_FLOPS_PER_S = 989e12
# the bound of a kernel row: the bytes the function must move at the card's
# memory rate (each frame reads 4 B of trace and writes 8 B of c and s;
# each trace writes a 4 B redo word), and its float32 operations at the
# card's rate outside the tensor cores, by the H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per frame, counted from csrc/oasis_ar1.cu with an expf
# as 10: the push, the attempts and one merge (merges never outnumber
# pushes) and the reconstruction; an upper estimate, under the bytes bound
OPS_PER_FRAME = {False: 60, True: 180}


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


_STARTED = time.perf_counter()


def report(phase: str, **fields) -> None:
    """One line of findings, ending with the script's seconds so far."""
    fields["script_s"] = round(time.perf_counter() - _STARTED, 1)
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


def _same(a, b):
    """Per lane of ``(..., T)`` outputs: equal bits (NaN equals NaN)."""
    eq = (a == b) | (a.isnan() & b.isnan())
    return eq.reshape(-1, a.shape[-1]).all(-1)


def _abs_err(a, b):
    """Largest ``|a - b|``, NaN against NaN counted as 0."""
    diff = (a - b).abs().masked_fill(a.isnan() & b.isnan(), 0.0)
    return float(diff.max()) if diff.numel() else 0.0


def compare_kernel(y, long=False, **kw):
    """Kernel and plain version on the same CUDA traces; the findings. With
    ``long``, the long entry and its plain twin; ``plain_ms`` is the plain
    call's own time by CUDA events; ``variant`` is the launch counter's key
    of the kernel call (machine, trace length and ring storage)."""
    import collections

    import torch
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    if long:
        kernel = oasis_cuda.oasis_ar1_long
        plain = oasis_torch.oasis_ar1_long_torch
    else:
        kernel, plain = oasis_cuda.oasis_ar1_cuda, oasis_torch.oasis_ar1_torch
    before = collections.Counter(oasis_cuda.launches)
    found = kernel(y, **kw)
    variant = list(oasis_cuda.launches - before)
    return dict(variant=variant, **_held_to_plain(found, plain, y, kw))


def _held_to_plain(found, plain, y, kw) -> dict:
    """The kernel's ``found`` (c, s, redo) on the CUDA traces ``y`` against
    ``plain(y, **kw)``, timed by CUDA events: the findings of
    :func:`compare_kernel` but its ``variant``."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    expected = plain(y, **kw)
    end.record()
    torch.cuda.synchronize()
    return dict(_lanes_vs(found, expected), plain_ms=start.elapsed_time(end))


def _lanes_vs(found, expected) -> dict:
    """The kernel's ``found`` (c, s, redo) against the plain version's
    ``expected`` on the same traces, lane for lane."""
    c, s, redo = found
    c_p, s_p, redo_p = expected
    same = _same(c, c_p) & _same(s, s_p) & (redo == redo_p).reshape(-1)
    flags = redo.reshape(-1)
    return dict(lanes=int(redo.numel()),
                lanes_differ=int((~same).sum()),
                bits_differ=int((redo != redo_p).sum()),
                flagged=int(redo.ne(0).sum()),
                max_abs_err=max(_abs_err(c, c_p), _abs_err(s, s_p)),
                bit_frac={f"bit{b}": float(((flags >> b) & 1).float().mean())
                          for b in range(3)},
                redo=[int(flags[0])], redo_plain=[int(
                    redo_p.reshape(-1)[0])])


def strip(found) -> dict:
    """:func:`compare_kernel`'s findings without the sample redo words."""
    return {k: v for k, v in found.items() if not k.startswith("redo")}


def check_equal(found, what: str) -> None:
    """Kernel = plain version bit for bit on every lane."""
    check(found["lanes_differ"] == 0 and found["max_abs_err"] == 0.0,
          f"{what}: kernel differs from its plain version on "
          f"{found['lanes_differ']} of {found['lanes']} lanes (max abs "
          f"error {found['max_abs_err']}, {found['bits_differ']} redo "
          f"words)")


def launched(prefix: str, counts=None) -> int:
    """Launches of one machine and trace length (``oasis_ar1``,
    ``oasis_ar1_long_precise``, ...) over both ring storages."""
    if counts is None:
        from calciumgan_tpu_torch.ops import oasis_cuda
        counts = oasis_cuda.launches
    return sum(n for key, n in counts.items() if key.split("/")[0] == prefix)


def path_launches(prefix: str, counts) -> dict:
    """A ``kernels`` entry's launches on its path: their count, by ring
    storage (``{"shared": n, "device": m}``) and the storages taken."""
    by_storage = {key.split("/")[1]: n for key, n in counts.items()
                  if key.split("/")[0] == prefix}
    return dict(launches=launched(prefix, counts),
                variant="/".join(sorted(by_storage)),
                launches_by_variant=by_storage)


def check_variant(found, key: str, what: str) -> None:
    check(found["variant"] == [key], f"{what}: launched {found['variant']}, "
                                     f"expected {key}")


def bound(B: int, T: int, precise: bool) -> dict:
    """The least time for OASIS on ``B`` traces of ``T`` frames: the larger
    of its bytes at the memory rate and its operations at the float32
    rate."""
    bytes_ms = (12 * B * T + 4 * B) / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_FRAME[precise] * B * T / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=12 * B * T + 4 * B)


def phase_kernel():
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops import golden
    from calciumgan_tpu_torch.ops import oasis as dispatch
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    host = golden.synth_ar1_traces(rng, KERNEL_TRACES, T)
    y = torch.from_numpy(host).to(dev)
    prod = production(dispatch._DEPTH_LADDER[0])
    # every rung of the ladder, and a depth whose ring is in device memory,
    # held to the plain version in the twins line (flush_twins)
    rungs = {d: defer_to_twin(y, production(d), "oasis_ar1/shared",
                              f"phase 2, classic, depth {d}")
             for d in dispatch._DEPTH_LADDER}
    rungs[1024] = defer_to_twin(y[:DEVICE_RING_TRACES], production(1024),
                                "oasis_ar1/device",
                                "phase 2, classic, depth 1024")

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
        check_equal(case, f"{name} edge case")
        check(case["redo"][0] & bit, f"{name} edge case: {case['redo']}")

    # the dispatch (ladder + float64 host redo) on the CUDA tensor
    spikes = dispatch.deconvolve_signals_host(y)
    golden = golden_spikes(host[:NUMPY_GOLDEN_TRACES])
    mismatches = int((spikes[:NUMPY_GOLDEN_TRACES] != golden).sum())
    cxx = int((spikes != dispatch._exact_spikes_host(
        host, G, S_MIN, THRESHOLD)).sum())
    check(mismatches == 0 and cxx == 0, f"dispatch spikes: {mismatches} "
          f"mismatches vs the golden, {cxx} vs the C++ float64 kernel")
    torch.cuda.synchronize()
    report("phase 2 kernel", shape=[KERNEL_TRACES, T], production=prod,
           rungs=rungs,
           edge_bits={"bit0": bit0["redo"][0], "bit1": bit1["redo"][0],
                      "bit2": bit2["redo"][0]},
           dispatch_vs_golden=dict(golden="oasis_ref",
                                   golden_traces=NUMPY_GOLDEN_TRACES,
                                   mismatches=mismatches,
                                   cxx_float64_traces=KERNEL_TRACES,
                                   cxx_float64_mismatches=cxx,
                                   spikes=int(golden.sum())))


def generator_reference_check(config, variables):
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
        outs[name] = [gan.generate(build_generator(cfg, variables, dev),
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


def phase_slice(config, variables):
    """Phase 3's timed part, ``generate`` with spikes on an idle card: its
    launches, and the function that checks what it served (run beside
    phase 5's spawned comparisons) and prints the line."""
    from calciumgan_tpu_torch.generate import generate
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    ref_errs = generator_reference_check(config, variables)

    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    start = time.perf_counter()
    payloads = list(generate(config, variables, BATCH * BATCHES, BATCH,
                             with_spikes=True, seed=SEED, device="cuda"))
    seconds = time.perf_counter() - start
    launches, calls = dict(oasis_cuda.launches), oasis_torch.calls
    return launches, lambda: _slice_checks(config, payloads, launches, calls,
                                           seconds, ref_errs)


def _slice_checks(config, payloads, launches, calls, seconds, ref_errs):
    """Phase 3's checks of ``generate``'s ``payloads``: shapes, ranges,
    launches, and the spikes against the C++ float64 kernel and the numpy
    golden; its line."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops import oasis as dispatch

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
    check(launches.get("oasis_ar1/shared", 0) > 0,
          f"the shared-memory OASIS kernel was not launched: {launches}")
    check(calls == 0, f"the plain OASIS version ran {calls} times")

    traces = np.ascontiguousarray(np.transpose(signals, (0, 2, 1))).reshape(
        -1, T)
    ours = np.transpose(spikes, (0, 2, 1)).reshape(-1, T)
    pick = np.random.default_rng(SEED).choice(len(traces), GOLDEN_TRACES,
                                              replace=False)
    golden = golden_spikes(traces[pick[:NUMPY_GOLDEN_TRACES]])
    mismatches = int((ours[pick[:NUMPY_GOLDEN_TRACES]] != golden).sum())
    cxx = int((ours[pick] != dispatch._exact_spikes_host(
        traces[pick], G, S_MIN, THRESHOLD)).sum())
    check(mismatches == 0 and cxx == 0, f"{mismatches} spike mismatches vs "
          f"the float64 golden, {cxx} vs the C++ float64 kernel")
    torch.cuda.synchronize()
    report("phase 3 slice", samples=len(signals), shape=list(shape),
           signals_range=[lo, hi], spikes=int(spikes.sum()),
           launches=launches, plain_calls=calls, seconds=round(seconds, 3),
           generator_vs_cpu=ref_errs, golden="oasis_ref",
           golden_traces=NUMPY_GOLDEN_TRACES, golden_spikes=int(golden.sum()),
           mismatches=mismatches, cxx_float64_traces=GOLDEN_TRACES,
           cxx_float64_mismatches=cxx)


def e2e_stages(config, variables, dev):
    """Host-clock seconds of each stage of one ``generate --spikes`` batch,
    as ``generate`` runs it, with a synchronize after each stage."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.algorithms import gan
    from calciumgan_tpu_torch.data.pipeline import reverse_preprocessing
    from calciumgan_tpu_torch.eval.spike_eval import deconvolve_traces
    from calciumgan_tpu_torch.generate import build_generator
    generator = build_generator(config, variables, dev)
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


def phase_timings(config, variables, smi):
    import numpy as np
    import torch
    from calciumgan_tpu_torch.algorithms import gan
    from calciumgan_tpu_torch.generate import build_generator, generate
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    dev = torch.device("cuda")
    generator = build_generator(config, variables, dev)
    noise = gan.get_noise(torch.Generator(device=dev).manual_seed(SEED),
                          BATCH, config.noise_dim, dev)
    gen_ms = cuda_ms(lambda: gan.generate(generator, noise), reps=10)

    traces = gan.generate(generator, noise).transpose(1, 2).contiguous()
    traces = traces.reshape(-1, T)  # (1024*102, 2048) generated traces
    kw = production(dispatch._DEPTH_LADDER[0])
    # the kernel vs its plain version at the main path's shape
    generated = compare_kernel(traces, **kw)
    check_equal(generated, "classic on generated traces")
    check_variant(generated, "oasis_ar1/shared", "classic on generated traces")
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

    for _ in generate(config, variables, BATCH, BATCH, True, SEED, dev):
        pass  # warm-up of the whole path
    start = time.perf_counter()
    n = sum(len(p["signals"]) for p in generate(
        config, variables, BATCH * BATCHES, BATCH, True, SEED, dev))
    e2e_s = time.perf_counter() - start
    stages = e2e_stages(config, variables, dev)
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
    return dict(ms=kernel_ms, plain_ms=plain_ms, shape=[B, T],
                max_abs_err=generated["max_abs_err"], **bound(B, T, False))


def _long_twins(prod: dict, parts) -> list:
    """The long kernel's plain version with ``prod`` in one call on the
    rows of several launches, held bit for bit to each launch's rows (a
    trace's lane depends on that trace alone): ``parts`` of ``(what,
    traces, launched_rows, variant)``, host arrays; where ``launched_rows``
    is None the kernel runs here on ``traces`` and must launch as
    ``variant``. The plain version launches a few hundred small kernels a
    frame, minutes at tens of thousands of frames, so the script runs this
    in spawned processes beside its other work. Each part's findings, with
    the one call's ``plain_ms`` and rows."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    found = []
    for what, traces, launched_rows, variant in parts:
        if launched_rows is None:
            y = torch.from_numpy(np.ascontiguousarray(traces, np.float32))
            before = collections.Counter(oasis_cuda.launches)
            found.append(oasis_cuda.oasis_ar1_long(y.cuda(), **prod))
            check_variant(dict(variant=list(oasis_cuda.launches - before)),
                          variant, what)
        else:
            found.append([torch.from_numpy(x).cuda() for x in launched_rows])
    y = torch.from_numpy(np.concatenate([np.asarray(part[1], np.float32)
                                         for part in parts]))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = oasis_torch.oasis_ar1_long_torch(y.cuda(), **prod)
    end.record()
    torch.cuda.synchronize()
    held, row = [], 0
    for (what, traces, _, _), kernel in zip(parts, found):
        rows = slice(row, row + len(traces))
        row = rows.stop
        lanes = dict(_lanes_vs(kernel, [t[rows] for t in plain]),
                     plain_ms=start.elapsed_time(end), plain_rows=len(y))
        check_equal(lanes, what)
        held.append(lanes)
    return held


class _Share:
    """One part's findings of a spawned :func:`_long_twins` call, as a
    future of its own."""

    def __init__(self, future, index: int):
        self.future, self.index = future, index

    def result(self):
        return self.future.result()[self.index]


def _spawned_pool(workers: int):
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def phase_recordings(smi, beside=()):
    """Whole recordings: the long kernel and the precise machine against
    their plain versions, the dispatch's long route against the float64
    references, and the spike-inference CLI on seeded pickles. Every time
    is taken first, on an idle card; then the long kernel's comparisons
    with its plain version (minutes at these frames) and the numpy golden
    run in spawned processes while this one runs ``beside`` (the untimed
    work of earlier phases), the edge cases and the checks against the C++
    float64 kernel."""
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
    prod = production(ladder[0], precise=True)

    # 1. the long kernel's times, production arguments
    long_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_long(y, **prod), reps=3)
    device_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_long(
        y, **dict(prod, depth=ladder[1])), reps=1)

    # 2. the short kernel's precise mode at sl2048 against its plain
    # version (whose time the kernels line reports, so on an idle card),
    # its time, and its own path, the public entry counted alone (no
    # production path runs that mode: the JAX package calls it only for an
    # A/B)
    short = torch.from_numpy(golden.synth_ar1_traces(
        np.random.default_rng(SEED), KERNEL_TRACES, T)).to(dev)
    short_kw = dict(g=G, lam=0.0, s_min=S_MIN,
                    depth=dispatch._DEPTH_LADDER[0],
                    merge_attempts=dispatch._MERGE_BUDGET, precise=True,
                    flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD,
                                                precise=True))
    precise_main = compare_kernel(short, **short_kw)
    check_equal(precise_main, "precise short, depth 64")
    check_variant(precise_main, "oasis_ar1_precise/shared",
                  "precise short, depth 64")
    precise_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_cuda(short, **short_kw),
                         reps=5)
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    _, _, redo_path = oasis_cuda.oasis_ar1(short, **short_kw)
    precise_launches = dict(oasis_cuda.launches)
    check(precise_launches.get("oasis_ar1_precise/shared", 0) > 0
          and oasis_torch.calls == 0,
          f"precise entry: {precise_launches}, plain calls "
          f"{oasis_torch.calls}")

    # 3. the dispatch's long route on the CUDA corpus
    before = launched("oasis_ar1_long_precise")
    spikes = dispatch.deconvolve_signals_host(y)
    rungs = ladder[:launched("oasis_ar1_long_precise") - before]
    start = time.perf_counter()
    spikes_again = dispatch.deconvolve_signals_host(
        torch.from_numpy(host).to(dev))
    dispatch_s = time.perf_counter() - start
    check(np.array_equal(spikes, spikes_again), "dispatch not repeatable")
    _, _, redo = oasis_cuda.oasis_ar1_long(y, **prod)
    flagged = np.nonzero(redo.cpu().numpy())[0]
    start = time.perf_counter()
    dispatch._exact_spikes_host(host[flagged], G, S_MIN, THRESHOLD)
    redo_s = time.perf_counter() - start

    # 4. the CLI on seeded whole-recording pickles: the main path
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
        check(cli_launches.get("oasis_ar1_long_precise/shared", 0) > 0,
              f"the shared-memory long kernel was not launched: "
              f"{cli_launches}")
        check(cli_calls == 0, f"the plain OASIS version ran {cli_calls} times")
        one = torch.from_numpy(recordings[0]).to(dev)  # one recording
        cli_kernel_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_long(one, **prod),
                                reps=3)
        torch.cuda.synchronize()

        # 5. nothing is timed from here on. Spawned: the long kernel against
        # its plain version at depth 512 (shared rings) and at the ladder's
        # deeper rungs (device rings) on 256 x 8192, one process each, and
        # the numpy golden of the dispatch's and the CLI's rows
        pick = np.sort(np.random.default_rng(SEED).choice(
            REC_TRACES, REC_GOLDEN_TRACES, replace=False))
        cli_rows = [np.sort(np.random.default_rng(SEED + i).choice(
            CLI_NEURONS, CLI_GOLDEN_ROWS, replace=False))
            for i in range(CLI_FILES)]
        deep = golden.synth_ar1_traces(np.random.default_rng(SEED + 7),
                                       DEVICE_RING_TRACES, DEVICE_RING_T)
        pool = _spawned_pool(len(ladder) + REC_GOLDEN_WORKERS + 1)
        try:
            held = pool.submit(_long_twins, prod, [(
                "long kernel, depth 512", host, None,
                "oasis_ar1_long_precise/shared")])
            held_rungs = {d: pool.submit(_long_twins, dict(prod, depth=d), [(
                f"long kernel, depth {d}", deep, None,
                "oasis_ar1_long_precise/device")]) for d in ladder[1:]}
            golden_parts = [pool.submit(golden_spikes, part) for part in
                            np.array_split(host[pick], REC_GOLDEN_WORKERS)]
            cli_golden_ref = pool.submit(golden_spikes, np.concatenate(
                [sig[rows] for sig, rows in zip(recordings, cli_rows)]))

            for task in beside:
                task()

            # redo-bit edge cases through the long and the precise short
            # entry
            ramp = torch.linspace(0.0, 10.0, 160, device=dev)[None].repeat(
                3, 1)
            bit0 = compare_kernel(ramp, long=True, s_min=0.0, depth=16,
                                  precise=True)
            dense = torch.from_numpy(golden.synth_ar1_traces(
                np.random.default_rng(SEED), 4, 128, rate=0.3)).to(dev)
            bit1 = compare_kernel(dense, long=True, s_min=S_MIN,
                                  merge_attempts=1, precise=True)
            # the precise band (tests/test_oasis_pallas.py:107-130): a 1e-5
            # margin resolves unflagged and as the float64 golden does,
            # 1e-8 sets bit 2
            edge = torch.zeros((1, 64), device=dev)
            edge[0, 0] = 2.0
            band = {}
            for name, margin in (("resolved", 1e-5), ("bit2", 1e-8)):
                edge[0, 1] = float(np.float32(G * 2.0 + S_MIN + margin))
                band[name] = compare_kernel(edge, g=G, s_min=S_MIN,
                                            flag_tol=1e-6, precise=True)
                if name == "resolved":
                    _, s_edge, _ = oasis_cuda.oasis_ar1_cuda(
                        edge, g=G, s_min=S_MIN, flag_tol=1e-6, precise=True)
                    ref = golden_spikes(edge.cpu().numpy())
                    check(np.array_equal(
                        (s_edge > THRESHOLD).cpu().numpy(), ref == 1),
                        "1e-5 margin: precise spikes differ from float64")
            for name, case, bit in (("bit0", bit0, 1), ("bit1", bit1, 2),
                                    ("bit2", band["bit2"], 4)):
                check_equal(case, f"precise {name} edge case")
                check(case["redo"][0] & bit,
                      f"{name} edge case: {case['redo']}")
            check_equal(band["resolved"], "precise 1e-5 margin")
            check(band["resolved"]["redo"] == [0],
                  f"1e-5 margin flagged: {band['resolved']['redo']}")

            check(int(redo_path.ne(0).sum()) == precise_main["flagged"],
                  "precise entry flags differ from the compared kernel's")

            exact = dispatch._exact_spikes_host(host, G, S_MIN, THRESHOLD)
            vs_cxx = int((spikes != exact).sum())
            check(vs_cxx == 0,
                  f"long dispatch: {vs_cxx} mismatches vs the C++ redo")
            outs = []
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
                outs.append(out[cli_rows[i]])
            with open(os.path.join(tmp, "rec0.pkl"), "rb") as f:
                recording = pickle.load(f)  # with its oasis key, for phase 7
            cli.main(["--input_dir", tmp, "--device", "cuda", "--clean"])
            for i in range(CLI_FILES):
                with open(os.path.join(tmp, f"rec{i}.pkl"), "rb") as f:
                    check("oasis" not in pickle.load(f), "--clean kept oasis")

            waited = time.perf_counter()
            golden_ref = np.concatenate([f.result() for f in golden_parts])
            vs_golden = int((spikes[pick] != golden_ref).sum())
            check(vs_golden == 0,
                  f"long dispatch: {vs_golden} mismatches vs oasis_ref")
            cli_golden = int((np.concatenate(outs)
                              != cli_golden_ref.result()).sum())
            check(cli_golden == 0,
                  f"CLI: {cli_golden} mismatches vs oasis_ref")
            long_main = held.result()[0]
            device_rungs = {d: f.result()[0] for d, f in held_rungs.items()}
            waited_s = time.perf_counter() - waited
        finally:
            pool.shutdown(cancel_futures=True)
    torch.cuda.synchronize()

    report("phase 5 recordings", card=smi, shape=[REC_TRACES, REC_T],
           production=prod, long_vs_plain=strip(long_main),
           long_kernel_ms=long_ms,
           long_kernel_traces_per_s=REC_TRACES / long_ms * 1e3,
           long_plain_ms=long_main["plain_ms"],
           long_plain_traces_per_s=REC_TRACES / long_main["plain_ms"] * 1e3,
           device_rings={d: dict(strip(f), shape=[DEVICE_RING_TRACES,
                                                   DEVICE_RING_T])
                         for d, f in device_rungs.items()},
           long_kernel_ms_depth_1024_device=device_ms,
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
                    mismatches_vs_golden=cli_golden),
           waited_for_the_spawned_s=waited_s)
    err = max(f["max_abs_err"] for f in (
        long_main, bit0, bit1, band["bit2"], *device_rungs.values()))
    precise_err = max(precise_main["max_abs_err"],
                      band["resolved"]["max_abs_err"])
    return dict(
        recording=recording, long_counts=cli_launches,
        precise=dict(**path_launches("oasis_ar1_precise", precise_launches),
                     path=f"oasis_cuda.oasis_ar1(precise=True), "
                          f"{KERNEL_TRACES} x {T}",
                     max_abs_err=precise_err, ms=precise_ms,
                     plain_ms=precise_main["plain_ms"],
                     **bound(KERNEL_TRACES, T, True)),
        long=dict(**path_launches("oasis_ar1_long_precise", cli_launches),
                  path="spike_train_inference --device cuda",
                  max_abs_err=err, ms=long_ms,
                  plain_ms=long_main["plain_ms"],
                  shape=[REC_TRACES, REC_T],
                  **bound(REC_TRACES, REC_T, True),
                  ms_per_recording=cli_kernel_ms,
                  bound_ms_per_recording=bound(CLI_NEURONS, REC_T,
                                               True)["bound_ms"],
                  device_ring_ms=device_ms))


class FixedDraws:
    """The methods of ``algorithms.gan.Draws`` returning preset draws (host
    numpy arrays, moved to ``device``), so a step runs on the same numbers
    on the card and on the CPU."""

    def __init__(self, noise, alpha, shifts, device, dropout=()):
        self.noise_q, self.alpha_q = list(noise), list(alpha)
        self.shift_q, self.device = list(shifts), device
        self.dropout_q = list(dropout)

    def noise(self, n, noise_dim):
        import torch
        return torch.from_numpy(self.noise_q.pop(0)).to(self.device)

    def alpha(self, n):
        import torch
        return torch.from_numpy(self.alpha_q.pop(0)).to(self.device)

    def shifts(self, m, count):
        return [self.shift_q.pop(0) for _ in range(count)]

    def dropout(self, shape, rate):
        import torch
        keep = self.dropout_q.pop(0)
        check(keep.shape == tuple(shape), f"mask {keep.shape} for {shape}")
        return torch.from_numpy(keep).to(self.device)


def write_training_set(root, train_rows=TRAIN_ROWS, val_rows=VAL_ROWS,
                       frames=T, seed=SEED + 11):
    """A flagship-shaped TFRecord dataset written by the port's writer:
    ``train_rows`` + ``val_rows`` rows of ``frames`` x 102 seeded synthetic
    calcium (``golden.synth_ar1_traces``), min-max normalised, with float32
    OASIS spikes by the port's C++ float64 kernel, and its ``info.pkl``."""
    import pickle

    import numpy as np
    from calciumgan_tpu_torch.data import tfrecord
    from calciumgan_tpu_torch.ops import golden
    from calciumgan_tpu_torch.ops import oasis as dispatch
    rows, C = train_rows + val_rows, 102
    traces = golden.synth_ar1_traces(np.random.default_rng(seed),
                                     rows * C, frames)
    spikes = dispatch._exact_spikes_host(traces, G, S_MIN, THRESHOLD)
    lo, hi = float(traces.min()), float(traces.max())
    signals = np.ascontiguousarray(
        ((traces - lo) / (hi - lo)).reshape(rows, C, frames).transpose(0, 2, 1))
    spikes = np.ascontiguousarray(spikes.reshape(rows, C, frames).transpose(
        0, 2, 1).astype(np.float32))
    os.makedirs(root, exist_ok=True)
    shards = {"train": np.array_split(np.arange(train_rows), 4),
              "validation": [np.arange(train_rows, rows)]}
    for split, parts in shards.items():
        for i, idx in enumerate(parts):
            tfrecord.write_signal_records(os.path.join(
                root, f"{split}-{i + 1:03d}-of-{len(parts):03d}.record"),
                signals, spikes, idx)
    info = {"train_size": train_rows, "validation_size": val_rows,
            "signal_shape": (frames, C), "spike_shape": (frames, C),
            "sequence_length": frames, "num_neurons": C, "num_channels": C,
            "num_train_shards": 4, "num_validation_shards": 1,
            "buffer_size": train_rows // 4, "normalize": True,
            "stride": frames,
            "fft": False, "conv2d": False, "fft_norm": "global",
            "signals_min": lo, "signals_max": hi}
    with open(os.path.join(root, "info.pkl"), "wb") as f:
        pickle.dump(info, f)
    return signals


def train_flags(records, run, epochs, *extra):
    """The flagship recipe's flags for ``calciumgan_tpu_torch.main``."""
    return ["--input_dir", records, "--output_dir", run,
            "--batch_size", "128", "--num_units", "64", "--kernel_size", "24",
            "--strides", "2", "--m", "10", "--layer_norm",
            "--mixed_precision", "--n_critic", "5", "--noise_dim", "32",
            "--algorithm", "wgan-gp", "--epochs", str(epochs),
            "--checkpoint_every", "1", "--seed", str(SEED),
            "--device", "cuda", "--verbose", "0", *extra]


class Spy:
    """Wraps functions of a module for the length of a ``with``: records
    each call's first arguments, result and host seconds."""

    def __init__(self, module, *names):
        self.module, self.names = module, names
        self.calls = {n: [] for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            setattr(self.module, n, self._wrap(n, self.saved[n]))
        return self

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            self.calls[name].append(dict(args=args, out=out,
                                         s=time.perf_counter() - start))
            return out
        return wrapped

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def _moment_errors(a_state, b_state) -> dict:
    """Largest difference of Adam's first moments (the step's gradients:
    ``0.1 g``, or ``0.09 g1 + 0.1 g2`` after the critic's two steps)
    between two states, over the net's largest moment."""
    errs = {}
    for name in ("generator", "discriminator"):
        a_net, b_net = getattr(a_state, name), getattr(b_state, name)
        pairs = [(a_net.optimizer.state[pa]["exp_avg"].cpu(),
                  b_net.optimizer.state[pb]["exp_avg"].cpu())
                 for pa, pb in zip(a_net.module.parameters(),
                                   b_net.module.parameters())]
        scale = max(float(b.abs().max()) for _, b in pairs)
        errs[name] = max(float((a - b).abs().max()) for a, b in pairs) / scale
    return errs


def _buffer_errors(a_state, b_state) -> float:
    """Largest difference of the generators' buffers (the BatchNorm
    running statistics) between two states; 0 without any."""
    pairs = zip(a_state.generator.module.buffers(),
                b_state.generator.module.buffers())
    return max((float((a.cpu() - b.cpu()).abs().max()) for a, b in pairs),
               default=0.0)


def steps_card_vs_cpu(make_config, real, draws, keys, bounds=None) -> dict:
    """One train step from one state and the same injected draws (``(noise,
    alpha, shifts)`` lists) on the card and on the CPU, in float32 (TF32
    off) and bfloat16, for the config ``make_config(bf16)``: the logs
    ``keys``, Adam's first moments and the generator's running statistics
    (where it has BatchNorm), each held to ``bounds`` (default: phase 6's
    ``STEP_*``; ``bf16_grad_gap`` lets a bfloat16 gradient also differ by
    that many times the CPU's own float32-vs-bfloat16 distance)."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.algorithms import get_algorithm
    from calciumgan_tpu_torch.models import get_models
    bounds = dict(dict(f32_loss=(STEP_F32_LOSS_RTOL, STEP_F32_LOSS_ATOL),
                       bf16_loss=(STEP_BF16_LOSS_RTOL, STEP_BF16_LOSS_ATOL),
                       f32_grad=STEP_F32_GRAD_TOL,
                       bf16_grad=STEP_BF16_GRAD_TOL, bf16_grad_gap=0.0,
                       f32_stats=STEP_F32_STATS_TOL,
                       bf16_stats=STEP_BF16_STATS_TOL), **(bounds or {}))
    found, cpu_runs = {}, {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        cfg = make_config(bf16)
        runs = {}
        for dev in ("cuda", "cpu"):
            algo = get_algorithm(cfg, *get_models(
                cfg, rng=torch.Generator().manual_seed(SEED), device=dev))
            state = algo.init_state()
            logs = algo.train_step(
                state, torch.from_numpy(real).to(dev),
                FixedDraws(*draws, dev))
            runs[dev] = (state, {k: float(v) for k, v in logs.items()})
        (gpu, gpu_logs), (cpu, cpu_logs) = runs["cuda"], runs["cpu"]
        cpu_runs[name] = runs["cpu"]
        check(all(np.isfinite(v) for v in gpu_logs.values()),
              f"{name} step: non-finite logs {gpu_logs}")
        found[name] = dict(
            logs_card=gpu_logs,
            loss_rel_err={k: abs(gpu_logs[k] - cpu_logs[k]) /
                          max(abs(cpu_logs[k]), 1e-30) for k in gpu_logs},
            loss_abs_err={k: abs(gpu_logs[k] - cpu_logs[k])
                          for k in gpu_logs},
            grad_err=_moment_errors(gpu, cpu),
            stats_err=_buffer_errors(gpu, cpu))
    # what the bf16 bounds are set against: float32 vs bfloat16 on the CPU
    (a, a_logs), (b, b_logs) = cpu_runs["bf16"], cpu_runs["f32"]
    found["cpu_f32_vs_bf16"] = dict(
        loss_abs_err={k: abs(a_logs[k] - b_logs[k]) for k in a_logs},
        grad_err=_moment_errors(a, b), stats_err=_buffer_errors(a, b))
    for name in ("f32", "bf16"):
        run = found[name]
        rtol, atol = bounds[f"{name}_loss"]
        for k in keys:
            check(run["loss_abs_err"][k] <= rtol * abs(run["logs_card"][k])
                  + atol, f"{name} step {k}: card vs CPU "
                          f"{run['loss_abs_err'][k]}")
        gap = found["cpu_f32_vs_bf16"]["grad_err"] if name == "bf16" \
            else {}
        for net, err in run["grad_err"].items():
            check(err <= max(bounds[f"{name}_grad"], bounds.get(
                f"{name}_grad_gap", 0.0) * gap.get(net, 0.0)),
                  f"{name} step gradients: card vs CPU {run['grad_err']}")
        check(run["stats_err"] <= bounds[f"{name}_stats"],
              f"{name} step running statistics: card vs CPU "
              f"{run['stats_err']}")
    return found


def step_card_vs_cpu(signals) -> dict:
    """One WGAN-GP step at full width (batch 8, n_critic 2) from one state
    and the same injected noise, alpha and shifts on the card and on the
    CPU, in float32 (TF32 off) and bfloat16: losses, GP and gradients.
    The learning rate is 0, so every gradient is taken at the parameters
    both devices share: Adam's first step, ``lr * g / (|g| + eps)``, would
    move a parameter by up to ``lr`` where ``|g|`` is near ``eps`` and the
    devices' roundings differ, and the later gradients with it."""
    import dataclasses

    import numpy as np
    B, n_critic = 8, 2
    rng = np.random.default_rng(SEED + 21)
    noise = [rng.standard_normal((B, 32)).astype(np.float32)
             for _ in range(n_critic + 1)]
    alpha = [rng.random(B).astype(np.float32) for _ in range(n_critic)]
    shifts = rng.integers(-10, 11, 4 * (2 * n_critic + 1)).tolist()
    return steps_card_vs_cpu(
        lambda bf16: dataclasses.replace(
            flagship_config(), mixed_precision=bf16, n_critic=n_critic,
            batch_size=B, learning_rate=0.0),
        np.ascontiguousarray(signals[:B]), (noise, alpha, shifts),
        ("loss/generator", "loss/discriminator", "loss/gradient_penalty"))


class _NoModuleTracker:
    """Stands in for ``FlopCounterMode``'s module tracker: every count goes
    to the global total."""
    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def time_train_step(signals, smi) -> dict:
    """The flagship step at batch 128 by CUDA events (10 steps after 2
    warm-ups), split into critic and generator steps by timing the same
    state at n_critic 5 and 1; its FLOPs by ``FlopCounterMode``; a
    checkpoint save by host clock."""
    import tempfile

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from calciumgan_tpu_torch.algorithms import get_algorithm
    from calciumgan_tpu_torch.algorithms.gan import Draws
    from calciumgan_tpu_torch.data.pipeline import DeviceStore
    from calciumgan_tpu_torch.models import get_models
    from calciumgan_tpu_torch.utils import checkpoint
    cfg = flagship_config()
    cfg.batch_size = 128
    dev = torch.device("cuda")
    algo = get_algorithm(cfg, *get_models(
        cfg, rng=torch.Generator().manual_seed(SEED), device=dev))
    state = algo.init_state()
    real = DeviceStore(signals[:128], dev).batch(list(range(128)))
    counter = iter(range(10**6))

    def step():
        algo.train_step(state, real, Draws(SEED, next(counter), dev))

    torch.cuda.reset_peak_memory_stats()
    ms = {}
    for n_critic in (5, 1):
        algo.n_critic = n_critic
        step()
        ms[n_critic] = cuda_ms(step, reps=10)  # after 2 warm-up steps
    algo.n_critic = 5
    critic_ms = (ms[5] - ms[1]) / 4
    counted = FlopCounterMode(display=False)
    # count by operator only: the per-module tracker's backward hooks
    # refuse the gradient penalty's autograd.grad on its input
    counted.mod_tracker = _NoModuleTracker()
    with counted:
        step()
    flops = counted.get_total_flops()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        checkpoint.save(tmp, 0, state, config=cfg, verbose=0)
        save_s = time.perf_counter() - start
        size_mb = os.path.getsize(checkpoint.port_checkpoint_path(tmp, 0)) \
            / 1e6
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    return dict(card=smi, step_ms=ms[5], step_ms_n_critic_1=ms[1],
                critic_step_ms=critic_ms,
                generator_step_ms=ms[1] - critic_ms,
                flops_per_step=flops, bound_ms=bound_ms,
                bf16_peak_share=bound_ms / ms[5], peak_memory_gb=peak_gb,
                checkpoint_save_s=save_s, checkpoint_mb=size_mb)


class _InlineBatches:
    """A ``HostBatches`` that the training epoch does not recognise: it
    gathers, pins and copies each batch on its own thread between steps
    (the streaming path without the prefetcher)."""

    def __init__(self, host):
        self.host = host

    def __len__(self):
        return len(self.host)

    def batch(self, idx):
        return self.host.batch(idx)


class _NoSummary:
    """What ``train.train_epoch`` asks of a summary, writing nothing."""

    profiler_dir = None

    def log(self, *args, **kwargs):
        pass


def _device_busy(fn) -> float:
    """The share of ``fn``'s host seconds in which the card ran a kernel or
    a copy that ``torch.profiler`` traced, spans left out
    (``tracing.device_work``, ``tracing.busy_seconds``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from calciumgan_tpu_torch.utils import tracing
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = tracing.device_work(list(prof.events()))
    check(bool(events), "the profiler traced nothing on the card")
    return tracing.busy_seconds(events) / wall


def batch_source_modes(smi, records) -> dict:
    """``train.train_epoch`` at the flagship recipe on phase 6's records in
    three modes on one state: the signals on the card (``DeviceStore``),
    streamed from the host through ``DevicePrefetcher`` (the training
    epoch's own choice for a ``HostBatches``), and streamed inline on the
    training thread (:class:`_InlineBatches`). First the prefetched batches
    of an epoch against the inline ones, bit for bit, and the side stream
    of their copies; then one untimed epoch a mode, ``PREFETCH_EPOCHS``
    timed epochs a mode taken in turn (steps/s each: median, spread) and
    one more a mode under ``torch.profiler`` for its device-busy share."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch import main as train_main
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.data import pipeline
    with tempfile.TemporaryDirectory() as out:
        config, _ = train_main.parse_args(train_flags(records, out, 1))
    train_ds, _ = pipeline.get_datasets(config)
    config.validate_model_shapes()
    dev = torch.device("cuda", torch.cuda.current_device())
    algo, _ = train.build_algorithm(config, dev)
    state = algo.init_state()
    host = pipeline.HostBatches(train_ds.signals, dev)
    sources = {"device_store": pipeline.DeviceStore(train_ds.signals, dev),
               "prefetcher": host, "inline": _InlineBatches(host)}

    batches = train.epoch_batches(config, 0, len(host))
    prefetcher = pipeline.DevicePrefetcher(host, batches)
    side = prefetcher.stream
    got = list(prefetcher)
    check(len(got) == len(batches) and all(
        torch.equal(a, host.batch(idx)) for a, idx in zip(got, batches)),
        "prefetched batches differ from the inline ones")
    check(side is not None and side.device == dev
          and side != torch.cuda.default_stream(dev)
          and side != torch.cuda.current_stream(dev),
          f"prefetcher copies on {side}, not a side stream of {dev}")
    batch_mb = got[0].numel() * got[0].element_size() / 2**20
    del got

    quiet = _NoSummary()

    def epoch(mode, n):
        train.train_epoch(config, sources[mode], algo, state, quiet, n, dev)

    for mode in sources:
        epoch(mode, 0)
    seconds = {mode: [] for mode in sources}
    for n in range(1, PREFETCH_EPOCHS + 1):
        for mode in sources:
            torch.cuda.synchronize()
            start = time.perf_counter()
            epoch(mode, n)
            seconds[mode].append(time.perf_counter() - start)
    steps = len(batches)
    modes = {}
    for mode in sources:
        rates = [steps / s for s in seconds[mode]]
        modes[mode] = dict(
            steps_per_s=rates, median=float(np.median(rates)),
            spread=[min(rates), max(rates)],
            device_busy_share=_device_busy(
                lambda: epoch(mode, PREFETCH_EPOCHS + 1)))
    store = modes["device_store"]["median"]
    return dict(card=smi, steps_per_epoch=steps, epochs=PREFETCH_EPOCHS,
                batch_mb=batch_mb, prefetched_equal_inline=True,
                side_stream=str(side), modes=modes,
                vs_device_store={m: modes[m]["median"] / store
                                 for m in modes})


def phase_training(smi, work):
    """The training slice: ``python -m calciumgan_tpu_torch.main
    --save_generated all`` at the flagship recipe on a written dataset,
    resumed, its generated files, its sampling epochs' OASIS launches and
    spikes, its checkpoint served; one step on the card against the CPU;
    the step's times and FLOPs. The run stays under ``work`` (``run``) for
    phase 8, the records (``records``) for phase 11."""
    import json

    import numpy as np
    import torch
    from calciumgan_tpu_torch import generate as generate_mod
    from calciumgan_tpu_torch import main as train_main
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.config import Config
    from calciumgan_tpu_torch.data.pipeline import DeviceStore
    from calciumgan_tpu_torch.models import get_models
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    from calciumgan_tpu_torch.utils import checkpoint, h5, io

    records, run = os.path.join(work, "records"), os.path.join(work, "run")
    start = time.perf_counter()
    signals = write_training_set(records)
    write_s = time.perf_counter() - start

    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    spy = Spy(train, "train_epoch", "validate_epoch", "sample_and_plot",
              "make_batch_sources")
    saves = Spy(io, "save_fake_signals")
    meta, wall = [], []
    with spy, saves:
        for epochs, extra in ((2, ("--profile",)), (3, ())):
            start = time.perf_counter()
            train_main.cli(train_flags(records, run, epochs,
                                       "--save_generated", "all", *extra))
            wall.append(time.perf_counter() - start)
            with open(os.path.join(run, "checkpoints",
                                   "latest.json")) as f:
                meta.append(json.load(f))
    launches, calls = dict(oasis_cuda.launches), oasis_torch.calls

    epochs = [c["args"][5] for c in spy.calls["train_epoch"]]
    check(epochs == [0, 1, 2], f"trained epochs {epochs}")
    check(meta == [{"epoch": 1, "global_step": 8},
                   {"epoch": 2, "global_step": 12}],
          f"latest.json {meta}")
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
    check(ckpts == ["epoch-000.pt", "epoch-001.pt", "epoch-002.pt",
                    "latest.json"], f"checkpoints {ckpts}")
    logs = [c["out"] for c in spy.calls["train_epoch"] +
            spy.calls["validate_epoch"]]
    check(all(np.isfinite(v) for d in logs for v in d.values()),
          f"non-finite losses {logs}")
    sources = [c["out"] for c in spy.calls["make_batch_sources"]]
    check(all(isinstance(s, DeviceStore) and s.signals.is_cuda
              for pair in sources for s in pair),
          f"dataset not on the card: {sources}")
    check(set(launches) == {"oasis_ar1/shared"}
          and launches["oasis_ar1/shared"] >= 3 and calls == 0,
          f"sampling epochs launched {launches}, plain calls {calls}")
    samples = spy.calls["sample_and_plot"]
    check(len(samples) == 3, f"{len(samples)} sampling epochs")
    mismatches = 0
    for c in samples:
        traces, spikes = c["out"]
        check(traces.shape == (102, T) and np.isfinite(traces).all(),
              f"sampled traces {traces.shape}")
        mismatches += int((spikes != golden_spikes(traces)).sum())
    check(mismatches == 0,
          f"sampled spikes: {mismatches} mismatches vs float64")

    # --save_generated all: the validation cache and one file an epoch,
    # VAL_ROWS rows each, in the container this installation writes
    cfg = Config(output_dir=run, verbose=0).load()
    suffix = h5.default_suffix(verbose=False)
    generated = sorted(os.listdir(os.path.join(run, "generated")))
    check(generated == [f"epoch{e:03d}_signals{suffix}" for e in range(3)]
          + ["info.pkl", "validation" + suffix],
          f"generated files {generated}")
    info = io.load_generated_info(cfg)
    check([info[e]["global_step"] for e in range(3)] == [4, 8, 12],
          f"info.pkl {info}")
    for name in [info[e]["filename"] for e in range(3)] + [
            cfg.validation_cache]:
        check(h5.get_shape(name, "signals") == (VAL_ROWS, T, 102),
              f"{name}: signals {h5.get_shape(name, 'signals')}")
    cached = h5.get(cfg.validation_cache, "signals")
    lo, hi = cfg.signals_min, cfg.signals_max
    cache_err = float(np.abs(cached - (signals[TRAIN_ROWS:] * (hi - lo)
                                       + lo)).max())
    check(cache_err <= 1e-5 * (hi - lo),
          f"validation cache differs from the dataset by {cache_err}")
    fake = h5.get(info[2]["filename"], "signals")
    check(bool(np.isfinite(fake).all()) and lo <= fake.min()
          and fake.max() <= hi, "epoch file outside the data's range")
    save_s = [c["s"] for c in saves.calls["save_fake_signals"]]
    check(len(save_s) == 3, f"{len(save_s)} saved batches")
    validate_s = [c["s"] for c in spy.calls["validate_epoch"]]

    # the parameters moved: the last checkpoint against the seeded init
    init_g, _ = get_models(cfg, rng=torch.Generator().manual_seed(SEED))
    stored = torch.load(checkpoint.port_checkpoint_path(
        os.path.join(run, "checkpoints"), 2), map_location="cpu",
        weights_only=True)
    moved = max(float((stored["generator"]["params"][k] - v).abs().max())
                for k, v in init_g.state_dict().items())
    check(moved > 0, "generator parameters did not move")

    # the newest checkpoint served as the generate CLI restores it
    params, epoch = checkpoint.restore_generator_params(
        os.path.join(run, "checkpoints"), ema=False)
    check(epoch == 2, f"served epoch {epoch}")
    oasis_cuda.launches.clear()
    served = list(generate_mod.generate(cfg, params, 256, 128,
                                        with_spikes=True, seed=SEED,
                                        device="cuda"))
    serve_launches = dict(oasis_cuda.launches)
    check(len(served) == 2 and all(
        p["signals"].shape == (128, T, 102)
        and np.isfinite(p["signals"]).all()
        and set(np.unique(p["spikes"]).tolist()) <= {0, 1}
        for p in served), "serving the trained checkpoint")
    with open(os.path.join(run, "profiler", "window.json")) as f:
        window = json.load(f)
    train_store = sources[-1][0]
    epoch_s = spy.calls["train_epoch"][-1]["s"]
    sample_s = [round(c["s"], 4) for c in samples]

    # the training epoch's three batch sources on the same state
    prefetch = batch_source_modes(smi, records)
    # step on the card vs the CPU, and the step's times
    torch.cuda.synchronize()
    versus = step_card_vs_cpu(signals)
    timing = time_train_step(signals, smi)
    steps = TRAIN_ROWS // 128
    report("phase 6 training", card=smi,
           dataset=dict(train=TRAIN_ROWS, validation=VAL_ROWS,
                        shape=[T, 102], write_s=write_s,
                        device_store_mb=train_store.nbytes / 2**20),
           runs=dict(epochs=epochs, latest=meta, wall_s=wall,
                     checkpoints=ckpts, train_logs=logs[:3],
                     sampling_launches=launches, plain_calls=calls,
                     sampled_traces=3 * 102, golden="oasis_ref",
                     mismatches=mismatches, generator_moved=moved,
                     served=dict(epoch=epoch, samples=256,
                                 launches=serve_launches)),
           save_generated=dict(files=generated, rows=VAL_ROWS,
                               container=suffix,
                               validation_cache_max_abs_err=cache_err,
                               validate_epoch_s=validate_s,
                               of_which_saving_s=save_s,
                               mb_per_epoch=fake.nbytes / 2**20),
           card_vs_cpu=versus, prefetch=prefetch,
           step=dict(timing, steps_per_s_host=steps / epoch_s,
                     epoch_host_s=epoch_s, steps_per_epoch=steps,
                     sample_and_plot_s=sample_s,
                     profile_window=window))
    return dict(launches=launches, timing=dict(
        timing, steps_per_s_host=steps / epoch_s), window=window, run=run,
        records=records, head=np.ascontiguousarray(signals[:8]),
        head_128=np.ascontiguousarray(signals[:DP_BATCH]))


def phase_prepare(smi, work, recording):
    """Dataset preparation: ``recording`` (a pickle's dict with ``signals``
    and the ``oasis`` key the spike-inference CLI wrote, 102 x 20,000)
    through ``python -m calciumgan_tpu_torch.dataset.generate_tfrecords`` and
    back through the port's ``get_datasets``."""
    import pickle
    import shutil

    import numpy as np
    from calciumgan_tpu_torch.config import Config
    from calciumgan_tpu_torch.data import pipeline, segments
    from calciumgan_tpu_torch.dataset import generate_tfrecords

    pkl, out = os.path.join(work, "rec0.pkl"), os.path.join(work, "prepared")
    with open(pkl, "wb") as f:
        pickle.dump(recording, f)
    start = time.perf_counter()
    generate_tfrecords.cli([
        "--input", pkl, "--output_dir", out, "--sequence_length", str(T),
        "--stride", str(PREP_STRIDE), "--normalize", "--validation_size",
        str(VAL_ROWS), "--verbose", "0"])
    write_s = time.perf_counter() - start
    start = time.perf_counter()
    cfg = Config(input_dir=out, batch_size=128)
    train_ds, val_ds = pipeline.get_datasets(cfg)
    load_s = time.perf_counter() - start

    # recorded data drops its first two rows; a window ending at the last
    # frame is excluded (the reference's strict bound)
    raw = np.asarray(recording["signals"], np.float32)[2:]
    oasis = np.asarray(recording["oasis"], np.float32)[2:]
    C = raw.shape[0]
    starts = segments.window_starts(REC_T, T, PREP_STRIDE)
    windows = len(starts)
    check(windows == -(-(REC_T - T) // PREP_STRIDE), f"{windows} windows")
    check((len(train_ds), len(val_ds)) == (windows - VAL_ROWS, VAL_ROWS)
          and (cfg.train_size, cfg.validation_size) == (
              windows - VAL_ROWS, VAL_ROWS),
          f"{len(train_ds)} + {len(val_ds)} rows of {windows} windows")
    check(cfg.signal_shape == (T, C) and cfg.spike_shape == (T, C)
          and train_ds.signals.shape == (windows - VAL_ROWS, T, C)
          and val_ds.spikes.shape == (VAL_ROWS, T, C)
          and cfg.num_neurons == C and cfg.normalize,
          f"shapes {train_ds.signals.shape} {val_ds.spikes.shape}")
    lo, hi = cfg.signals_min, cfg.signals_max
    check(float(train_ds.signals.min()) >= 0.0
          and float(train_ds.signals.max()) <= 1.0,
          "normalised signals outside [0, 1]")
    # row j of the train split is window order[j]: the shuffle of
    # write_dataset (RandomState(1234)) over the shards in order
    order = np.arange(windows)
    np.random.RandomState(1234).shuffle(order)
    worst = 0.0
    for ds, rows in ((train_ds, (0, 1, len(train_ds) - 1)),
                     (val_ds, (0, VAL_ROWS - 1))):
        offset = 0 if ds is train_ds else windows - VAL_ROWS
        for j in rows:
            a = int(starts[order[offset + j]])
            check(np.array_equal(ds.spikes[j], oasis[:, a:a + T].T),
                  f"window {order[offset + j]}: spikes differ")
            worst = max(worst, float(np.abs(
                np.asarray(ds.signals[j]) * (hi - lo) + lo
                - raw[:, a:a + T].T).max()))
    check(worst <= 1e-5 * (hi - lo),
          f"a window differs from the recording by {worst}")
    records_mb = sum(os.path.getsize(os.path.join(out, n))
                     for n in os.listdir(out) if n.endswith(".record")) / 2**20
    report("phase 7 dataset preparation", card=smi,
           recording=[int(raw.shape[0]) + 2, REC_T], windows=windows,
           stride=PREP_STRIDE, train=len(train_ds), validation=len(val_ds),
           signal_shape=list(cfg.signal_shape),
           shards=[cfg.num_train_shards, cfg.num_validation_shards],
           records_mb=records_mb, windows_checked=5,
           window_max_abs_err=worst, generate_tfrecords_s=write_s,
           get_datasets_s=load_s)
    shutil.rmtree(out)


def synth_ar1_on_card(n: int, frames: int, seed: int):
    """``golden.synth_ar1_traces``' calcium drawn on the card: Bernoulli
    spikes of 0.02 a frame, the AR(1) ``c[t] = G c[t-1] + s[t]`` by the
    log-depth scan of ``spike_metrics.first_order_recurrence``, Gaussian
    noise of scale 0.3, from a generator seeded with ``seed``; host
    float32 ``(n, frames)``."""
    import torch
    from calciumgan_tpu_torch.ops.spike_metrics import first_order_recurrence
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    spikes = (torch.rand((n, frames), generator=gen, device=dev)
              < 0.02).float()
    _, calcium = first_order_recurrence(torch.full_like(spikes, G), spikes)
    del spikes
    calcium += 0.3 * torch.randn((n, frames), generator=gen, device=dev)
    return calcium.cpu().numpy()


def write_eval_run(root, train_run, trials=EVAL_TRIALS, frames=T,
                   batch_size=125, neurons=EVAL_NEURONS, on_card=False):
    """A run directory of ``trials`` x ``frames`` x ``neurons`` for
    ``compute_metrics``: the recorded side is seeded synthetic calcium with
    spikes by the port's C++ float64 kernel, written by
    ``io.cache_validation_set``; the generated side comes from
    ``generate.generate`` on ``train_run``'s newest checkpoint (without
    one, the flagship generator at ``frames`` frames with seeded random
    weights), written by ``io.save_fake_signals``, ``batch_size`` rows a
    batch. ``on_card``: the recorded side's calcium is drawn on the card
    (:func:`synth_ar1_on_card`) rather than by the numpy loop, which takes
    20-27 s at 16,320 x 16,384. The data are in recording units
    (``normalize`` off). Returns its config, the epoch and the seconds."""
    import dataclasses

    import numpy as np
    import torch
    from calciumgan_tpu_torch import convert
    from calciumgan_tpu_torch import generate as generate_mod
    from calciumgan_tpu_torch.config import Config
    from calciumgan_tpu_torch.data import pipeline
    from calciumgan_tpu_torch.models import get_models
    from calciumgan_tpu_torch.ops import golden
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.utils import checkpoint, io
    N, C = trials, neurons
    seconds, clock = {}, time.perf_counter()

    def lap(name):
        nonlocal clock
        now = time.perf_counter()
        seconds[name], clock = now - clock, now

    cfg = Config(output_dir=root, save_generated="all",
                 batch_size=batch_size, sequence_length=frames,
                 num_neurons=C, num_channels=C, signal_shape=(frames, C),
                 spike_shape=(frames, C), validation_size=N,
                 normalize=False, seed=SEED, verbose=0)
    pipeline.set_generated_paths(cfg)
    if on_card:
        traces = synth_ar1_on_card(N * C, frames, SEED + 31)
    else:
        traces = golden.synth_ar1_traces(np.random.default_rng(SEED + 31),
                                         N * C, frames)
    lap("synthesise")
    spikes = dispatch._exact_spikes_host(traces, G, S_MIN, THRESHOLD)
    lap("cxx_spikes")
    nwc = [np.ascontiguousarray(x.reshape(N, C, frames).transpose(0, 2, 1))
           for x in (traces, spikes.astype(np.float32))]
    del traces, spikes
    io.cache_validation_set(cfg, pipeline.ArrayDataset(*nwc))
    del nwc
    lap("cache_validation_set")

    if train_run is None:
        train_cfg = dataclasses.replace(
            flagship_config(), sequence_length=frames, num_neurons=C,
            num_channels=C, signal_shape=(frames, C))
        weights, _ = get_models(train_cfg,
                                rng=torch.Generator().manual_seed(SEED))
        params = convert.flax_generator_variables(weights.state_dict())
        epoch = 0
    else:
        train_cfg = Config(output_dir=train_run, verbose=0).load()
        params, epoch = checkpoint.restore_generator_params(
            os.path.join(train_run, "checkpoints"), ema=False)
    cfg.global_step = 12
    for i, payload in enumerate(generate_mod.generate(
            train_cfg, params, N, cfg.batch_size, with_spikes=False,
            seed=SEED + 5, device="cuda")):
        io.save_fake_signals(cfg, epoch, payload["signals"], append=i > 0)
    lap("generate_and_save")
    cfg.save()
    return cfg, epoch, seconds


def stats_card_vs_cpu(real, fake, trials=EVAL_CPU_TRIALS, extra=()):
    """The statistics of ``trials`` trials of NWC spikes (tensors on the
    card) against the same functions on the CPU. ``extra``: more ``(name,
    fn, trials, reference)`` per-trial statistics. Without a
    ``reference``, one is held as van Rossum's d**2 is, relative to its
    largest value (STAT_VR_RTOL: Victor-Purpura's DP sums the same float32
    costs in the same order on both). A ``reference`` gives, from host NWC
    spikes, the statistic in float64 and a scale per value: the error over
    the scale is held to STAT_CORR_TOL, and both devices' errors against
    float64 are reported (a covariance over ``sigma_i sigma_j`` is a
    correlation's error in covariance's units; over its largest value it
    would measure the cancellation of near-zero pairs instead)."""
    import numpy as np
    from calciumgan_tpu_torch.eval import spike_eval
    from calciumgan_tpu_torch.ops import spike_metrics as sm
    found = {}
    references = {e[0]: e[3] for e in extra}
    for name, fn, n in (
            ("firing_rate", spike_eval._firing_rates_nwc, trials),
            ("correlation", spike_eval._per_trial_upper_corr, trials),
            ("van_rossum", spike_eval._per_trial_upper_van_rossum, trials),
            *(e[:3] for e in extra)):
        sides, seconds = {}, {"card": 0.0, "cpu": 0.0}
        errs, vs_float64 = [], {}
        for side, spikes in (("real", real[:n]), ("fake", fake[:n])):
            start = time.perf_counter()
            card = fn(spikes).cpu().numpy()
            middle = time.perf_counter()
            cpu = fn(spikes.cpu()).numpy()
            seconds["card"] += middle - start
            seconds["cpu"] += time.perf_counter() - middle
            sides[side] = card, cpu
            check(np.array_equal(np.isnan(card), np.isnan(cpu)),
                  f"{name}: NaN masks differ between the card and the CPU")
            if name == "van_rossum":  # on d**2, over its largest
                errs.append(float(np.nanmax(np.abs(card ** 2 - cpu ** 2))
                                  / np.nanmax(cpu ** 2)))
            elif references.get(name) is not None:  # over the scale
                exact, scale = references[name](spikes.cpu().numpy())
                errs.append(float(np.nanmax(np.abs(card - cpu) / scale)))
                for k, x in (("card", card), ("cpu", cpu)):
                    vs_float64[k] = max(vs_float64.get(k, 0.0), float(
                        np.nanmax(np.abs(x - exact) / scale)))
            elif name in references:  # over its largest
                errs.append(float(np.nanmax(np.abs(card - cpu))
                                  / max(np.nanmax(np.abs(cpu)), 1e-30)))
            else:
                errs.append(float(np.nanmax(np.abs(card - cpu)))
                            if np.isfinite(cpu).any() else 0.0)
        kls = {}
        for k, where in (("card", 0), ("cpu", 1)):
            r, f = sides["real"][where], sides["fake"][where]
            if name == "firing_rate":  # per neuron, over the trials
                pairs = [(r[:, c], f[:, c]) for c in range(r.shape[1])]
            else:                      # per trial, NaN pairs dropped
                pairs = [(r[i][~np.isnan(r[i])], f[i][~np.isnan(f[i])])
                         for i in range(n)]
            kls[k] = sm.pairs_kl_divergence(
                pairs, device="cuda" if k == "card" else "cpu")
        check(np.array_equal(np.isnan(kls["card"]), np.isnan(kls["cpu"])),
              f"{name}: the KLs' NaN masks differ")
        diff = np.abs(kls["card"] - kls["cpu"])
        found[name] = dict(
            trials=n, seconds=seconds, max_err=max(errs),
            max_err_by_side=dict(zip(sides, errs)),
            **({"vs_float64": vs_float64} if vs_float64 else {}),
            kl_mean_card=float(np.nanmean(kls["card"])),
            kl_mean_cpu=float(np.nanmean(kls["cpu"])),
            kl_max_diff=float(np.nanmax(diff)) if np.isfinite(
                diff).any() else 0.0,
            kls_moved=int(np.nansum(diff > 1e-4)))
    check(found["firing_rate"]["max_err"] == 0.0,
          f"firing rates: card vs CPU {found['firing_rate']['max_err']}")
    check(found["correlation"]["max_err"] <= STAT_CORR_TOL,
          f"correlation: card vs CPU {found['correlation']['max_err']}")
    check(found["van_rossum"]["max_err"] <= STAT_VR_RTOL,
          f"van Rossum d**2: card vs CPU {found['van_rossum']['max_err']} "
          f"of the largest")
    for name, *_ in extra:
        bound_, of = ((STAT_CORR_TOL, "of its scale")
                      if references[name] is not None
                      else (STAT_VR_RTOL, "of the largest"))
        check(found[name]["max_err"] <= bound_,
              f"{name}: card vs CPU {found[name]['max_err']} {of}")
    for name, f in found.items():
        check(abs(f["kl_mean_card"] - f["kl_mean_cpu"]) <= STAT_KL_TOL
              or not np.isfinite(f["kl_mean_cpu"]),
              f"{name}: mean KL {f['kl_mean_card']} on the card, "
              f"{f['kl_mean_cpu']} on the CPU")
    return found


def _metrics_cli(output_dir, *extra) -> dict:
    """``python -m calciumgan_tpu_torch.compute_metrics --device cuda`` on
    ``output_dir`` in-process, the launch counts set to 0 just before it:
    its results, config, launches, plain calls, seconds by stage, and its
    seconds and peak device memory in all."""
    import torch
    from calciumgan_tpu_torch import compute_metrics
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    torch.cuda.reset_peak_memory_stats()
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    config, options = compute_metrics.parse_args(
        ["--output_dir", output_dir, "--device", "cuda", "--verbose", "0",
         "--seed", str(SEED), *extra])
    stages = {}
    start = time.perf_counter()
    results = compute_metrics.main(config, seconds=stages, **options)
    torch.cuda.synchronize()
    return dict(results=results, config=config,
                seconds=time.perf_counter() - start,
                launches=dict(oasis_cuda.launches),
                plain_calls=oasis_torch.calls, stages=stages,
                peak_gb=torch.cuda.max_memory_allocated() / 2**30)


def phase_evaluation(smi, work, train_run):
    """Evaluation at the paper's size through ``python -m
    calciumgan_tpu_torch.compute_metrics --device cuda``, then the same CLI
    with ``--all_epochs`` on the training phase's own run."""
    import dataclasses

    import numpy as np
    import torch
    from calciumgan_tpu_torch.eval import spike_eval
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.ops import spike_metrics as sm
    from calciumgan_tpu_torch.utils import h5, io
    from calciumgan_tpu_torch.utils.summary import Summary
    N, C = EVAL_TRIALS, EVAL_NEURONS
    run = os.path.join(work, "eval_run")
    cfg, epoch, setup_s = write_eval_run(run, train_run)
    filename = io.load_generated_info(cfg)[epoch]["filename"]
    check(h5.get_shape(filename, "signals") == (N, T, C) and h5.get_shape(
        cfg.validation_cache, "spikes") == (N, T, C),
        f"run directory: {h5.get_shape(filename, 'signals')}")

    # 1. the main path: one epoch file of 1000 x 2048 x 102
    main_run = _metrics_cli(run)
    launches = main_run["launches"]
    results = main_run["results"][epoch]
    with open(os.path.join(run, "metrics", "metrics.json")) as f:
        saved = json.load(f)
    check(list(main_run["results"]) == [epoch] and saved["epochs"][
        str(epoch)] == results, f"metrics.json {saved}")
    for key in ("firing_rate_kl", "correlation_kl", "van_rossum_kl"):
        check(np.isfinite(results[key]), f"{key} of synthetic data: "
                                         f"{results[key]}")
        check(saved["best_epoch"][key] == epoch, f"best_epoch {saved}")
    check(main_run["config"].num_samples == N,
          f"num_samples {main_run['config'].num_samples}")
    # every rung of the short ladder keeps its ring in shared memory, so
    # no launch of this path takes the device ring
    check(set(launches) == {"oasis_ar1/shared"}
          and main_run["plain_calls"] == 0,
          f"compute_metrics launched {launches}, plain calls "
          f"{main_run['plain_calls']}")
    chunks = -(-N // (spike_eval._CHUNK_TRACES_CUDA // C))
    per_file = launches.get("oasis_ar1/shared", 0)
    check(chunks <= per_file <= 3 * chunks,  # one to three rungs a chunk
          f"{launches} launches for {chunks} chunks")

    # 2. the epoch file's spikes against the float64 references
    signals = h5.get(filename, "signals")
    spikes = h5.get(filename, "spikes")
    check(spikes.shape == (N, T, C) and spikes.dtype == np.int8
          and set(np.unique(spikes).tolist()) <= {0, 1},
          f"spikes {spikes.shape} {spikes.dtype}")
    traces = np.ascontiguousarray(signals.transpose(0, 2, 1)).reshape(-1, T)
    ours = np.ascontiguousarray(spikes.transpose(0, 2, 1)).reshape(-1, T)
    start = time.perf_counter()
    exact = dispatch._exact_spikes_host(traces, G, S_MIN, THRESHOLD)
    cxx_s = time.perf_counter() - start
    vs_cxx = int((ours != exact).sum())
    check(vs_cxx == 0, f"{vs_cxx} spike mismatches vs the C++ float64 kernel")
    pick = np.sort(np.random.default_rng(SEED).choice(
        len(traces), EVAL_GOLDEN_TRACES, replace=False))
    start = time.perf_counter()
    golden = golden_spikes(traces[pick])
    golden_s = time.perf_counter() - start
    vs_golden = int((ours[pick] != golden).sum())
    check(vs_golden == 0, f"{vs_golden} spike mismatches vs float64")
    stages = main_run["stages"][epoch]
    dispatched = stages.get("deconvolve/traces", 0)
    flag_share = {k: stages.get(f"deconvolve/{k}", 0) / max(1, dispatched)
                  for k in ("flagged", "bit0", "bit1", "bit2")}

    # 3. the statistics on the card against the CPU
    dev = torch.device("cuda")
    real = spike_eval._load_spikes(cfg, cfg.validation_cache,
                                   EVAL_CPU_TRIALS, dev)
    fake = spike_eval._load_spikes(cfg, filename, EVAL_CPU_TRIALS, dev)
    versus = stats_card_vs_cpu(real, fake)

    # where a per-trial statistic's seconds go: its tensor program over
    # all the generated trials, and the histogram KL of as many pairs
    every = spike_eval._load_spikes(cfg, filename, N, dev)
    split = {}
    for name, fn in (("correlation", spike_eval._per_trial_upper_corr),
                     ("van_rossum", spike_eval._per_trial_upper_van_rossum)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        values = spike_eval.chunked(fn, every)
        program_s = time.perf_counter() - start
        pairs = [(row[~np.isnan(row)],) * 2 for row in values]
        start = time.perf_counter()
        sm.pairs_kl_divergence(pairs, device=dev)
        split[name] = dict(tensor_program_s=program_s, trials=N,
                           pairs_kl_s=time.perf_counter() - start, pairs=N)
    del every

    # 4. Victor-Purpura, on EVAL_VP_TRIALS trials only
    vp_cfg = dataclasses.replace(main_run["config"], trials=[0, 1],
                                 num_samples=EVAL_VP_TRIALS)
    summary = Summary(vp_cfg, spike_metrics=True, no_plots=True)
    torch.cuda.synchronize()
    start = time.perf_counter()
    vp_kl = spike_eval.victor_purpura_metrics(
        vp_cfg, summary, real[:EVAL_VP_TRIALS], fake[:EVAL_VP_TRIALS], epoch)
    torch.cuda.synchronize()
    vp_s = time.perf_counter() - start
    summary.close()
    check(len(vp_kl) == EVAL_VP_TRIALS and bool(np.isfinite(vp_kl).any()),
          f"Victor-Purpura KLs {vp_kl}")
    spikes_per_train = dict(
        real=float(real.sum() / (EVAL_CPU_TRIALS * C)),
        fake=float(fake.sum() / (EVAL_CPU_TRIALS * C)))

    # 5. the unbroken chain: the training phase's own run, every epoch
    chain = _metrics_cli(train_run, "--all_epochs")
    check(sorted(chain["results"]) == [0, 1, 2]
          and chain["config"].num_samples == VAL_ROWS
          and chain["plain_calls"] == 0
          and set(chain["launches"]) == {"oasis_ar1/shared"},
          f"chain: epochs {sorted(chain['results'])}, {chain['launches']}")
    for e, r in chain["results"].items():
        check(np.isfinite(r["firing_rate_kl"]),
              f"chain epoch {e}: firing-rate KL {r['firing_rate_kl']}")
        name = io.load_generated_info(chain["config"])[e]["filename"]
        check(h5.get_shape(name, "spikes") == (VAL_ROWS, T, 102),
              f"chain epoch {e}: spikes {h5.get_shape(name, 'spikes')}")

    torch.cuda.synchronize()
    report("phase 8 evaluation", card=smi,
           run=dict(trials=N, shape=[T, C], container=os.path.splitext(
               filename)[1], setup_s=setup_s,
               epoch_file_mb=signals.nbytes / 2**20),
           kls_of_seeded_synthetic_data=results,
           best_epoch=saved["best_epoch"],
           seconds_per_epoch_file=main_run["seconds"],
           stages_s=stages,
           launches=launches, launches_per_file=per_file,
           chunks=chunks, plain_calls=main_run["plain_calls"],
           flag_share=flag_share, traces_dispatched=dispatched,
           spikes=dict(generated=int(spikes.sum()),
                       mean_per_train=spikes_per_train,
                       golden="oasis_ref", golden_traces=EVAL_GOLDEN_TRACES,
                       golden_s=golden_s, mismatches_vs_golden=vs_golden,
                       cxx_traces=len(traces), cxx_s=cxx_s,
                       mismatches_vs_cxx=vs_cxx),
           card_vs_cpu=dict(trials=EVAL_CPU_TRIALS, **versus),
           statistic_split=split,
           victor_purpura=dict(trials=EVAL_VP_TRIALS, seconds=vp_s,
                               s_per_trial=vp_s / EVAL_VP_TRIALS,
                               kl_mean_of_synthetic_data=float(
                                   np.nanmean(vp_kl))),
           chain=dict(run="phase 6's", epochs=sorted(chain["results"]),
                      rows=VAL_ROWS, seconds=chain["seconds"],
                      launches=chain["launches"],
                      kls_of_seeded_synthetic_data=chain["results"]))
    return dict(launches=launches, chain_launches=chain["launches"])


def _rate_check(spikes, mean, covariance, what: str) -> dict:
    """DG spikes ``(neurons, frames)`` against the probability the sampler
    gives each neuron from the parameters the CLI passes it: ``Phi(mu /
    sigma)`` with ``sigma**2`` the data's variance, since the CLI hands the
    sampler the data's covariance where it takes a correlation matrix (as
    the JAX package and the reference do)."""
    import numpy as np
    import torch
    frames = spikes.shape[1]
    sigma = np.sqrt(np.diag(covariance))
    expected = torch.special.ndtr(torch.from_numpy(mean[0] / sigma)).numpy()
    got = spikes.mean(1, dtype=np.float64)
    bound = DG_RATE_SIGMAS * np.sqrt(expected * (1 - expected) / frames) \
        + 1e-4
    worst = float(np.max(np.abs(got - expected) / bound))
    check(worst <= 1.0, f"{what}: a neuron's firing probability is "
                        f"{worst:.2f} bounds from Phi(mu / sigma)")
    return dict(expected_mean=float(expected.mean()),
                sampled_mean=float(got.mean()),
                worst_over_bound=worst, sigmas=DG_RATE_SIGMAS)


def dg_data_cli(pkl, out) -> dict:
    """``python -m calciumgan_tpu_torch.dataset.generate_dg_data --device
    cuda`` in-process on the recording pickle ``pkl``: the written
    dictionary checked, the seconds by stage, the rates."""
    import pickle

    import numpy as np
    from calciumgan_tpu_torch.dataset import generate_dg_data
    with open(pkl, "rb") as f:
        recorded = np.asarray(pickle.load(f)["oasis"], np.float64)[2:]
    stages = {}
    found = generate_dg_data.run(generate_dg_data.parse_args(
        ["--input", pkl, "--output", out, "--seed", str(SEED), "--device",
         "cuda"]), seconds=stages)
    with open(out, "rb") as f:
        data = pickle.load(f)
    C, frames = recorded.shape
    check(set(data) == {"signals", "oasis", "mean", "covariance"}
          and data["signals"].shape == data["oasis"].shape == (C, frames)
          and data["signals"].dtype == data["oasis"].dtype == np.float32
          and data["mean"].shape == (1, C)
          and data["covariance"].shape == (C, C),
          f"DG pickle: { {k: v.shape for k, v in data.items()} }")
    check(set(np.unique(data["oasis"]).tolist()) <= {0.0, 1.0}
          and bool(np.isfinite(data["signals"]).all()),
          "DG spikes not binary or signals not finite")
    rates = _rate_check(data["oasis"], data["mean"], data["covariance"], pkl)
    return dict(data=data, report=dict(
        shape=[C, frames], seconds=stages,
        took_higham_branch=found["projected"],
        recorded_rate_per_frame=float(recorded.mean()),
        dg_rate_per_frame=float(data["oasis"].mean()),
        dg_spikes=int(data["oasis"].sum()), rate_vs_phi_mu_over_sigma=rates))


def ar1_filter_check(spikes) -> dict:
    """``ar1_filter`` on the card against the CPU on all of ``spikes``
    (neurons, frames) and against a float64 sequential loop on 8 rows."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops.oasis import ar1_filter
    x = torch.from_numpy(spikes)
    card = ar1_filter(x.cuda()).cpu().numpy()
    cpu = ar1_filter(x).numpy()
    loop = spikes[:8].astype(np.float64)
    for t in range(2, loop.shape[1]):
        loop[:, t] = spikes[:8, t] + G * loop[:, t - 1]
    errs = dict(card_vs_cpu=float(np.abs(card - cpu).max()),
                card_vs_float64_loop=float(np.abs(card[:8] - loop).max()),
                calcium_max=float(card.max()))
    check(max(errs["card_vs_cpu"], errs["card_vs_float64_loop"])
          <= AR_FILTER_TOL, f"ar1_filter on the card: {errs}")
    ms = cuda_ms(lambda: ar1_filter(x.cuda()), reps=5)
    return dict(errs, tol=AR_FILTER_TOL, ms_with_upload=ms)


def dg_full_fit(spikes) -> dict:
    """The fit the CLI never calls: every pair's latent correlation on the
    card against the CPU, for fixed rates (timebins 1) and for a
    time-varying layout, then a sampler built from the fitted matrix and
    its sampled moments against the data's. ``spikes``: (neurons, frames)
    binary."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops.dg import DGOptimise, DichotGauss
    C, frames = spikes.shape
    layouts = {
        "timebins_1": np.transpose(spikes)[None],        # (1, frames, C)
        f"timebins_{DG_TIMEBINS}": np.ascontiguousarray(np.transpose(
            spikes[:, :DG_TIMEBINS * DG_TRIALS]).reshape(
                DG_TRIALS, DG_TIMEBINS, C).transpose(1, 0, 2))}
    found, fits = {}, {}
    for name, data in layouts.items():
        # pairs are fitted independently, so the CPU's fit of the first
        # neurons is held against that block of the card's whole matrix
        # (all of it for fixed rates; the time-varying CPU fit costs 9 ms
        # a pair)
        n_cpu = C if data.shape[0] == 1 else DG_CPU_NEURONS
        opt, opt_cpu = DGOptimise(data), DGOptimise(data[..., :n_cpu])
        opt.get_gauss_correlation(device="cuda")  # warm-up of the card's
        torch.cuda.synchronize()
        start = time.perf_counter()
        card = fits[name] = opt.get_gauss_correlation(device="cuda")
        seconds = {"cuda": time.perf_counter() - start}
        start = time.perf_counter()
        cpu = opt_cpu.get_gauss_correlation(device="cpu")
        seconds["cpu"] = time.perf_counter() - start
        err = float(np.abs(card[:n_cpu, :n_cpu] - cpu).max())
        check(card.dtype == np.float64 and err <= DG_FIT_TOL,
              f"DG fit {name}: card vs CPU {err}")
        check(bool(np.isfinite(card).all())
              and np.array_equal(np.diag(card), np.ones(C)),
              f"DG fit {name}: not a correlation matrix")
        found[name] = dict(shape=list(data.shape), pairs=C * (C - 1) // 2,
                           pairs_on_cpu=n_cpu * (n_cpu - 1) // 2,
                           card_vs_cpu=err, seconds=seconds,
                           largest_offdiagonal=float(np.abs(
                               card - np.eye(C)).max()))

    # a sampler from the fixed-rate fit: its moments against the data's
    opt = DGOptimise(layouts["timebins_1"])
    sampler = DichotGauss(C, mean=opt.gauss_mean,
                          corr=fits["timebins_1"], make_pd=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    torch.cuda.synchronize()
    start = time.perf_counter()
    sampled = sampler.sample(gen, repeats=DG_FIT_SAMPLES)[0]  # (repeats, C)
    centred = sampled.double() - sampled.double().mean(0)
    cov = (centred.T @ centred / DG_FIT_SAMPLES).cpu().numpy()
    rate = sampled.double().mean(0).cpu().numpy()
    sample_s = time.perf_counter() - start
    target = opt.data_tfix_covariance
    cov_err = float(np.abs(cov - target).max())
    rate_err = float(np.abs(rate - layouts["timebins_1"].mean((0, 1))).max())
    check(cov_err <= DG_MOMENT_TOL and rate_err <= DG_MOMENT_TOL,
          f"sampler from the fitted matrix: covariance {cov_err}, rate "
          f"{rate_err} from the data's")
    found["sampler_from_fit"] = dict(
        samples=DG_FIT_SAMPLES, covariance_max_abs_err=cov_err,
        rate_max_abs_err=rate_err, tol=DG_MOMENT_TOL, seconds=sample_s,
        took_higham_branch=sampler.projected)
    # ndtri at the clamped ends, float64, card against the CPU
    p = torch.tensor([1e-4, 1 - 1e-4, 0.5, 0.02], dtype=torch.float64)
    ndtri_err = float((torch.special.ndtri(p.cuda()).cpu()
                       - torch.special.ndtri(p)).abs().max())
    check(ndtri_err <= 1e-12, f"ndtri on the card vs the CPU: {ndtri_err}")
    found["ndtri_card_vs_cpu"] = ndtri_err
    return found


def gan_step_card_vs_cpu() -> dict:
    """One vanilla-GAN step of the mlp model (batch 8, dropout 0.2, float32
    with TF32 off, learning rate 0) from one state and the same noise and
    masks on the card and on the CPU: both gradients come from one
    forward."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.algorithms import get_algorithm
    from calciumgan_tpu_torch.config import Config
    from calciumgan_tpu_torch.models import get_models
    B = 8
    cfg = Config(model="mlp", algorithm="gan", sequence_length=6,
                 num_neurons=2, num_channels=2, signal_shape=(6, 2),
                 normalize=True, signals_min=0.0, signals_max=1.0,
                 batch_size=B, learning_rate=0.0, seed=SEED)
    rng = np.random.default_rng(SEED + 51)
    noise = [rng.standard_normal((B, cfg.noise_dim)).astype(np.float32)]
    widths = [cfg.num_units * k for k in (1, 2, 3, 4, 3, 2, 1)]
    masks = [rng.random((B if i < 3 else 2 * B, 6, w)) < 0.8
             for i, w in enumerate(widths)]
    real = rng.random((B, 6, 2)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        algo = get_algorithm(cfg, *get_models(
            cfg, rng=torch.Generator().manual_seed(SEED), device=dev))
        state = algo.init_state()
        draws = FixedDraws(noise, [], [], dev, dropout=masks)
        logs = algo.train_step(state, torch.from_numpy(real).to(dev), draws)
        check(not draws.dropout_q, "the step left dropout masks undrawn")
        runs[dev] = (state, {k: float(v) for k, v in logs.items()})
    (gpu, gpu_logs), (cpu, cpu_logs) = runs["cuda"], runs["cpu"]
    check(all(np.isfinite(v) for v in gpu_logs.values()),
          f"gan step: non-finite logs {gpu_logs}")
    abs_err = {k: abs(gpu_logs[k] - cpu_logs[k]) for k in gpu_logs}
    grad_err = _moment_errors(gpu, cpu)
    for k in ("loss/generator", "loss/discriminator"):
        check(abs_err[k] <= STEP_F32_LOSS_RTOL * abs(gpu_logs[k])
              + STEP_F32_LOSS_ATOL, f"gan step {k}: card vs CPU {abs_err[k]}")
    check(max(grad_err.values()) <= STEP_F32_GRAD_TOL,
          f"gan step gradients: card vs CPU {grad_err}")
    return dict(logs_card=gpu_logs, loss_abs_err=abs_err, grad_err=grad_err)


def production(depth: int, precise: bool = False) -> dict:
    """The dispatch's arguments of the classic kernel at ``depth``, or
    with ``precise`` of the precise machine (the long route's)."""
    from calciumgan_tpu_torch.ops import oasis as dispatch
    kw = dict(g=G, lam=0.0, s_min=S_MIN, depth=depth,
              merge_attempts=dispatch._MERGE_BUDGET,
              flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD, precise=precise))
    return dict(kw, precise=True) if precise else kw


# the classic kernel's launches whose comparison with the plain version is
# deferred (defer_to_twin), by (frames, arguments): flush_twins holds all
# the launches of a key to one plain call on their rows, since the plain
# version's time is set by frames and launches, not rows
_TWINS: dict = collections.defaultdict(list)


def defer_to_twin(y, kw: dict, variant: str, what: str) -> dict:
    """The classic kernel on the CUDA traces ``y`` (N, T) with ``kw``,
    launched as ``variant``; its rows and outputs kept on the host for
    :func:`flush_twins`. The launch's findings."""
    from calciumgan_tpu_torch.ops import oasis_cuda
    before = collections.Counter(oasis_cuda.launches)
    c, s, redo = oasis_cuda.oasis_ar1_cuda(y, **kw)
    found = dict(variant=list(oasis_cuda.launches - before),
                 lanes=int(redo.numel()), flagged=int(redo.ne(0).sum()),
                 shape=list(y.shape), plain="held in the twins line")
    check_variant(found, variant, what)
    _TWINS[(y.shape[-1], tuple(sorted(kw.items())))].append(dict(
        what=what, y=y.cpu().numpy(), c=c.cpu().numpy(), s=s.cpu().numpy(),
        redo=redo.cpu().numpy()))
    return found


def flush_twins() -> float:
    """Every deferred launch (:func:`defer_to_twin`) held to the plain
    version bit for bit: one plain call a (frames, arguments) on the rows
    of all its launches, each launch's lanes compared to its rows' (a
    trace's lane depends on that trace alone). Prints the ``twins`` line;
    returns the largest error."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops import oasis_torch
    if not _TWINS:
        return 0.0
    found, err = {}, 0.0
    for (frames, args), launches in _TWINS.items():
        kw = dict(args)
        y = torch.from_numpy(np.concatenate([e["y"] for e in launches]))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = oasis_torch.oasis_ar1_torch(y.cuda(), **kw)
        end.record()
        torch.cuda.synchronize()
        held, row = [], 0
        for e in launches:
            rows = slice(row, row + len(e["y"]))
            row = rows.stop
            lanes = _lanes_vs([torch.from_numpy(e[k]).cuda()
                               for k in ("c", "s", "redo")],
                              [t[rows] for t in plain])
            check_equal(lanes, e["what"])
            held.append(dict(strip(lanes), what=e["what"]))
            err = max(err, lanes["max_abs_err"])
        found[f"{frames} frames, depth {kw['depth']}"] = dict(
            rows=row, plain_ms=start.elapsed_time(end), launches=held)
        del plain
    _TWINS.clear()
    torch.cuda.empty_cache()
    report("twins", plain_calls=len(found), held=found)
    return err


def hold_to_twin(traces, rungs: int, what: str) -> dict:
    """The classic kernel on host ``traces`` (N, T) uploaded as they are,
    with the dispatch's production arguments at the first ``rungs`` depths
    of the ladder it walks for that length (``min(T, depth)``), each launch
    deferred to :func:`flush_twins`, which holds it to the plain version
    bit for bit. The launches by depth."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops import oasis as dispatch
    y = torch.from_numpy(np.ascontiguousarray(traces, np.float32)).cuda()
    ladder = tuple(dict.fromkeys(min(y.shape[-1], d)
                                 for d in dispatch._DEPTH_LADDER))
    found = {depth: defer_to_twin(y, production(depth), "oasis_ar1/shared",
                                  f"{what}, depth {depth}")
             for depth in ladder[:rungs]}
    check(len(found) == rungs, f"{what}: {rungs} launches on a ladder of "
                               f"{ladder}")
    return found


def sampled_vs_golden(calls, shape, what: str) -> int:
    """The ``(traces, spikes)`` pairs that ``train.sample_and_plot``
    returned, each of ``shape``: spike mismatches against the float64
    golden over all of them, which must be none."""
    import numpy as np
    mismatches = 0
    for call in calls:
        traces, spikes = call["out"]
        check(traces.shape == spikes.shape == shape
              and bool(np.isfinite(traces).all()),
              f"{what}: sampled traces {traces.shape}")
        mismatches += int((spikes != golden_spikes(traces)).sum())
    check(mismatches == 0, f"{what}: {mismatches} sampled spikes differ "
                           f"from float64")
    return mismatches


def head_of_run_without_spikes(run, copy, trials: int) -> str:
    """A run directory ``copy`` of the first ``trials`` rows of ``run``'s
    validation cache and of its newest epoch file, the epoch file without
    its spikes: all that ``compute_dg_metrics --num_trials trials`` reads of
    a run, for a device that has to deconvolve for itself. Returns the
    copy's epoch file."""
    import pickle

    from calciumgan_tpu_torch.config import Config
    from calciumgan_tpu_torch.utils import h5, io
    cfg = Config(output_dir=run, verbose=0).load()
    info = io.load_generated_info(cfg)
    epoch = max(info)
    generated = os.path.join(copy, "generated")
    os.makedirs(generated)
    cache = os.path.join(generated, os.path.basename(cfg.validation_cache))
    h5.write(cache, {name: h5.get(cfg.validation_cache, name, start=0,
                                  stop=trials)
                     for name in ("signals", "spikes")})
    filename = os.path.join(generated,
                            os.path.basename(info[epoch]["filename"]))
    h5.write(filename, {"signals": h5.get(info[epoch]["filename"], "signals",
                                          start=0, stop=trials)})
    with open(os.path.join(generated, "info.pkl"), "wb") as f:
        pickle.dump({epoch: dict(info[epoch], filename=filename)}, f)
    cfg.output_dir, cfg.generated_dir, cfg.validation_cache = (
        copy, generated, cache)
    cfg.save()
    return filename


def phase_dg(smi, work, recording):
    """The DG experiments: ``generate_dg_data`` on ``recording`` (one of
    phase 5's pickles) and on a dense seeded recording, the full fit on the
    card, then ``generate_tfrecords --is_dg_data -> main --ema
    --device_store off --save_generated last -> compute_dg_metrics`` at 100
    channels x 2048, and ``generate_surrogate_data -> main --model mlp
    --algorithm gan`` at the surrogate set's defaults."""
    import pickle

    import numpy as np
    import torch
    from calciumgan_tpu_torch import compute_dg_metrics
    from calciumgan_tpu_torch import generate as generate_mod
    from calciumgan_tpu_torch import main as train_main
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.algorithms import gan
    from calciumgan_tpu_torch.algorithms.gan import Draws
    from calciumgan_tpu_torch.config import Config
    from calciumgan_tpu_torch.data import pipeline
    from calciumgan_tpu_torch.dataset import (generate_surrogate_data,
                                              generate_tfrecords,
                                              spike_train_inference)
    from calciumgan_tpu_torch.ops import golden
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    from calciumgan_tpu_torch.utils import checkpoint, h5, io
    root = os.path.join(work, "dg")
    os.makedirs(os.path.join(root, "dense"))

    # 1. the DG data CLI: on the sparse recording of phase 5 (0.02 spikes a
    # frame: Phi(mu / sigma) leaves it no DG spike), then on a dense one
    # with correlated neurons, whose spikes the spike-inference CLI infers
    sparse_pkl = os.path.join(root, "rec0.pkl")
    with open(sparse_pkl, "wb") as f:
        pickle.dump(recording, f)
    sparse = dg_data_cli(sparse_pkl, os.path.join(root, "sparse_dg.pkl"))
    dense_pkl = os.path.join(root, "dense", "rec.pkl")
    traces = golden.synth_ar1_traces(np.random.default_rng(SEED + 61),
                                     CLI_NEURONS + 1, REC_T,
                                     rate=DG_DENSE_RATE)
    with open(dense_pkl, "wb") as f:  # the last row is a source all share
        pickle.dump({"signals": traces[:-1] + DG_SHARED * traces[-1]}, f)
    start = time.perf_counter()
    spike_train_inference.main(["--input_dir", os.path.dirname(dense_pkl),
                                "--device", "cuda"])
    inference_s = time.perf_counter() - start
    dg_pkl = os.path.join(root, "data.pkl")
    dense = dg_data_cli(dense_pkl, dg_pkl)
    check(dense["report"]["dg_spikes"] > 10000,
          f"the dense recording's DG has {dense['report']['dg_spikes']} "
          f"spikes")
    filtered = ar1_filter_check(dense["data"]["oasis"])

    # 2. the full fit on the card
    with open(dense_pkl, "rb") as f:
        inferred = np.asarray(pickle.load(f)["oasis"], np.float32)[2:]
    fit = dg_full_fit(inferred)

    # 3. records, training with the EMA from host batches, DG metrics
    records, run = os.path.join(root, "records"), os.path.join(root, "run")
    start = time.perf_counter()
    generate_tfrecords.cli([
        "--input", dg_pkl, "--output_dir", records, "--sequence_length",
        str(T), "--stride", str(DG_STRIDE), "--normalize", "--is_dg_data",
        "--validation_size", str(DG_VAL_ROWS), "--verbose", "0"])
    records_s = time.perf_counter() - start
    info = pipeline.load_info(records)
    C = CLI_NEURONS - 2
    check(info["num_neurons"] == C and info["signal_shape"] == (T, C)
          and info["validation_size"] == DG_VAL_ROWS,
          f"DG records: {info['signal_shape']}, {info['validation_size']}")
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    spy = Spy(train, "train_epoch", "validate_epoch", "make_batch_sources",
              "sample_and_plot")
    start = time.perf_counter()
    with spy:
        train_main.cli(train_flags(
            records, run, 2, "--ema", "0.999", "--device_store", "off",
            "--save_generated", "last"))
    train_s = time.perf_counter() - start
    train_launches, calls = dict(oasis_cuda.launches), oasis_torch.calls
    dg_epoch_s = [c["s"] for c in spy.calls["train_epoch"]]
    check(set(train_launches) == {"oasis_ar1/shared"}
          and train_launches["oasis_ar1/shared"] >= 2 and calls == 0,
          f"DG sampling epochs launched {train_launches}, plain calls "
          f"{calls}")
    # what those launches wrote, against the float64 golden, and the kernel
    # against its plain version at a sampling epoch's shape
    dg_samples = spy.calls["sample_and_plot"]
    check(len(dg_samples) == 2, f"{len(dg_samples)} DG sampling epochs")
    dg_sample_diff = sampled_vs_golden(dg_samples, (C, T),
                                       "DG sampling epochs")
    dg_sample_twin = hold_to_twin(dg_samples[-1]["out"][0], 1,
                                  "DG sampling epoch")
    sources = spy.calls["make_batch_sources"][0]["out"]
    check(all(isinstance(s, pipeline.HostBatches) for s in sources),
          f"--device_store off: batches from {sources}")
    logs = [c["out"] for c in spy.calls["train_epoch"]
            + spy.calls["validate_epoch"]]
    check(len(logs) == 4 and all(np.isfinite(v) for d in logs
                                 for v in d.values()),
          f"DG training: non-finite losses {logs}")
    steps = info["train_size"] // 128
    # the EMA side-car: other weights than the raw generator's, what the
    # validation pass saved and what generate serves
    ckpt_dir = os.path.join(run, "checkpoints")
    stored = torch.load(checkpoint.port_checkpoint_path(ckpt_dir, 1),
                        map_location="cpu", weights_only=True)
    ema_gap = max(float((stored["ema"][k] - v).abs().max())
                  for k, v in stored["generator"]["params"].items())
    check(ema_gap > 0, "the generator EMA equals the raw generator")
    cfg = Config(output_dir=run, verbose=0).load()
    fake_file = io.load_generated_info(cfg)[1]["filename"]
    check(h5.get_shape(fake_file, "signals") == (DG_VAL_ROWS, T, C),
          f"DG epoch file {h5.get_shape(fake_file, 'signals')}")
    saved = h5.get(fake_file, "signals")
    # the last epoch's one validation batch, generated again from its noise
    noise = Draws(SEED, train._VALIDATION_COUNTER + 1, "cuda").noise(
        128, cfg.noise_dim)
    served, replayed = {}, {}
    for ema in (True, False):
        params, epoch = checkpoint.restore_generator_params(
            ckpt_dir, ema=ema, model=cfg.model)
        served[ema] = next(generate_mod.generate(
            cfg, params, 8, 8, seed=SEED, device="cuda"))["signals"]
        again = pipeline.reverse_preprocessing(cfg, gan.generate(
            generate_mod.build_generator(cfg, params, "cuda"), noise))
        replayed[ema] = float(np.abs(
            again[:DG_VAL_ROWS].float().cpu().numpy() - saved).max())
    check(epoch == 1 and bool(np.isfinite(served[True]).all())
          and float(np.abs(served[True] - served[False]).max()) > 0,
          "generate serves the raw generator where the run kept an EMA")
    check(replayed[True] < 0.1 * replayed[False],
          f"--save_generated: the epoch file is {replayed[True]} from the "
          f"EMA generator's output and {replayed[False]} from the raw one's")

    def dg_metrics(device, output_dir=run):
        config, _ = compute_dg_metrics.parse_args(
            ["--output_dir", output_dir, "--device", device])
        config.verbose = 0
        stages = {}
        start = time.perf_counter()
        results = compute_dg_metrics.main(config, device=device,
                                          seconds=stages)
        torch.cuda.synchronize()
        return results, config, stages, time.perf_counter() - start

    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    results, metrics_cfg, stages, metrics_s = dg_metrics("cuda")
    metrics_launches = dict(oasis_cuda.launches)
    metrics_calls = oasis_torch.calls
    check(set(metrics_launches) == {"oasis_ar1/shared"}
          and metrics_calls == 0,
          f"compute_dg_metrics launched {metrics_launches}, plain calls "
          f"{metrics_calls}")
    flat = {f"{a}/{b}": v for a, d in results.items() for b, v in d.items()}
    check(all(np.isfinite(v) for v in flat.values()),
          f"DG metrics of synthetic data: {flat}")
    check(h5.get_shape(fake_file, "spikes") == (DG_VAL_ROWS, T, C)
          and stages.get("traces") == DG_VAL_ROWS * C,
          f"DG epoch file's spikes: {stages}")
    # the spikes that call wrote, against the float64 references, and the
    # kernel against its plain version at the file's shape on every rung
    # the call climbed
    file_spikes = h5.get(fake_file, "spikes")
    check(file_spikes.dtype == np.int8
          and set(np.unique(file_spikes).tolist()) <= {0, 1},
          f"DG epoch file's spikes: {file_spikes.dtype}")
    traces = np.ascontiguousarray(h5.get(fake_file, "signals").transpose(
        0, 2, 1)).reshape(-1, T)
    ours = np.ascontiguousarray(file_spikes.transpose(0, 2, 1)).reshape(
        -1, T)
    vs_cxx = int((ours != dispatch._exact_spikes_host(
        traces, G, S_MIN, THRESHOLD)).sum())
    check(vs_cxx == 0, f"DG epoch file: {vs_cxx} spike mismatches vs the "
                       f"C++ float64 kernel")
    pick = np.sort(np.random.default_rng(SEED).choice(
        len(traces), DG_GOLDEN_TRACES, replace=False))
    vs_golden = int((ours[pick] != golden_spikes(traces[pick])).sum())
    check(vs_golden == 0, f"DG epoch file: {vs_golden} spike mismatches vs "
                          f"float64")
    file_twin = hold_to_twin(traces, metrics_launches["oasis_ar1/shared"],
                             "DG epoch file")
    # the statistics on the card against the CPU, then the whole CLI with
    # --device cpu on a copy of the trials it reads, without their spikes:
    # the CPU deconvolves for itself, by the plain version
    stat_errs = {}
    for name, filename in (("dg", metrics_cfg.validation_cache),
                           ("generated", fake_file)):
        card = compute_dg_metrics.get_data_statistics(metrics_cfg, filename,
                                                      "cuda")
        cpu = compute_dg_metrics.get_data_statistics(metrics_cfg, filename,
                                                     "cpu")
        stat_errs[name] = dict(
            firing_rate=float(np.abs(card[0] - cpu[0]).max()),
            covariance=float(np.abs(card[1] - cpu[1]).max()))
        check(stat_errs[name]["firing_rate"] == 0.0
              and stat_errs[name]["covariance"] <= STAT_CORR_TOL,
              f"DG statistics of {name}: card vs CPU {stat_errs[name]}")
    check(metrics_cfg.num_trials == DG_CPU_TRIALS,
          f"compute_dg_metrics read {metrics_cfg.num_trials} trials")
    cpu_run = os.path.join(root, "run_cpu")
    cpu_file = head_of_run_without_spikes(run, cpu_run, DG_CPU_TRIALS)
    oasis_torch.calls = 0
    on_cpu, _, cpu_stages, cpu_s = dg_metrics("cpu", cpu_run)
    cpu_calls = oasis_torch.calls
    check(cpu_stages.get("traces") == DG_CPU_TRIALS * C and cpu_calls > 0,
          f"--device cpu did not deconvolve its copy: {cpu_stages}, "
          f"{cpu_calls} plain calls")
    cpu_spike_diff = int((h5.get(cpu_file, "spikes")
                          != file_spikes[:DG_CPU_TRIALS]).sum())
    check(cpu_spike_diff == 0, f"compute_dg_metrics: {cpu_spike_diff} spikes "
                               f"differ between --device cuda and cpu")
    cli_err = max(abs(v - on_cpu[k.split("/")[0]][k.split("/")[1]])
                  / max(abs(v), 1e-30) for k, v in flat.items())
    check(cli_err <= 1e-5, f"compute_dg_metrics: --device cuda vs cpu "
                           f"{cli_err} relative")

    # 4. the surrogate set at its defaults, the mlp model, vanilla GAN
    surrogate = os.path.join(root, "surrogate")
    start = time.perf_counter()
    generate_surrogate_data.main(["--output_dir", surrogate, "--seed",
                                  str(SEED), "--device", "cuda"])
    surrogate_s = time.perf_counter() - start
    for name in ("surrogate", "ground_truth"):
        with open(os.path.join(surrogate, name + ".pkl"), "rb") as f:
            spikes = pickle.load(f)["spikes"]
        check(spikes.shape == (SURROGATE_SAMPLES, 2, 6)
              and spikes.dtype == np.float32, f"{name}.pkl {spikes.shape}")
        rate = spikes.mean((0, 2), dtype=np.float64)
        expected = torch.special.ndtr(torch.tensor(
            [0.6, 0.8], dtype=torch.float64)).numpy()
        check(float(np.abs(rate - expected).max()) <= 2e-3,
              f"{name}.pkl rates {rate}, expected {expected}")
    del spikes
    with open(os.path.join(surrogate, "training.pkl"), "rb") as f:
        training = pickle.load(f)
    check(training["signals"].shape == training["spikes"].shape
          == (9192, 2, 6) and bool(np.isfinite(training["signals"]).all()),
          f"training.pkl {training['signals'].shape}")
    mlp_run = os.path.join(root, "run_mlp")
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    spy = Spy(train, "train_epoch", "validate_epoch",
              "generate_surrogate_dataset", "sample_and_plot")
    start = time.perf_counter()
    with spy:
        train_main.cli([
            "--input_dir", surrogate, "--output_dir", mlp_run, "--model",
            "mlp", "--algorithm", "gan", "--epochs", str(MLP_EPOCHS),
            "--checkpoint_every", "1", "--seed", str(SEED), "--device",
            "cuda", "--verbose", "0"])
    mlp_s = time.perf_counter() - start
    mlp_launches, calls = dict(oasis_cuda.launches), oasis_torch.calls
    check(set(mlp_launches) == {"oasis_ar1/shared"}
          and mlp_launches["oasis_ar1/shared"] >= MLP_EPOCHS and calls == 0,
          f"mlp sampling epochs launched {mlp_launches}, plain calls {calls}")
    # 2 traces of 6 frames: fewer frames than a ring is deep, part of a warp
    mlp_samples = spy.calls["sample_and_plot"]
    check(len(mlp_samples) == MLP_EPOCHS,
          f"{len(mlp_samples)} mlp sampling epochs")
    mlp_sample_diff = sampled_vs_golden(mlp_samples, (2, 6),
                                        "mlp sampling epochs")
    mlp_sample_twin = hold_to_twin(mlp_samples[-1]["out"][0], 1,
                                   "mlp sampling epoch")
    mlp_logs = [c["out"] for c in spy.calls["train_epoch"]
                + spy.calls["validate_epoch"]]
    check(len(mlp_logs) == 2 * MLP_EPOCHS
          and all(np.isfinite(v) for d in mlp_logs for v in d.values())
          and "loss/gradient_penalty" not in mlp_logs[0],
          f"mlp training: {mlp_logs}")
    mlp_cfg = Config(output_dir=mlp_run, verbose=0).load()
    check(mlp_cfg.model == "mlp" and mlp_cfg.algorithm == "gan"
          and mlp_cfg.surrogate_ds and mlp_cfg.signal_shape == (6, 2),
          f"mlp run: {mlp_cfg.model}, {mlp_cfg.signal_shape}")
    with open(os.path.join(mlp_run, "generated.pkl"), "rb") as f:
        generated = pickle.load(f)["signals"]
    check(generated.shape == (SURROGATE_SAMPLES, 6, 2)
          and generated.dtype == np.float32
          and bool(np.isfinite(generated).all()),
          f"generated.pkl {generated.shape}")
    versus = gan_step_card_vs_cpu()

    torch.cuda.synchronize()
    report("phase 9 DG experiments", card=smi,
           dg_data_cli=dict(
               note="both packages pass the data's covariance where the "
                    "sampler takes a correlation matrix, as the reference "
                    "does: a neuron fires with Phi(mu / sigma)",
               phase5_recording=sparse["report"],
               dense_recording=dict(dense["report"],
                                    spikes_per_frame_synthesised=DG_DENSE_RATE,
                                    shared_source_weight=DG_SHARED,
                                    spike_inference_cli_s=inference_s)),
           ar1_filter=filtered, full_fit=fit,
           dg_run=dict(records=dict(windows=info["train_size"]
                                    + info["validation_size"],
                                    stride=DG_STRIDE, shape=[T, C],
                                    generate_tfrecords_s=records_s),
                       flags="flagship recipe, --ema 0.999 --device_store "
                             "off --save_generated last",
                       epochs=2, steps_per_epoch=steps, seconds=train_s,
                       train_epoch_s=dg_epoch_s,
                       batches="HostBatches", ema_vs_raw_max_abs=ema_gap,
                       epoch_file_vs_ema_generator=replayed[True],
                       epoch_file_vs_raw_generator=replayed[False],
                       sampling_launches=train_launches,
                       sampled_traces=2 * C, golden="oasis_ref",
                       mismatches_vs_golden=dg_sample_diff,
                       kernel_vs_plain=dg_sample_twin),
           compute_dg_metrics=dict(
               of_seeded_synthetic_data=results, seconds=metrics_s,
               stages_s=stages, launches=metrics_launches,
               plain_calls=metrics_calls,
               spikes=dict(generated=int(file_spikes.sum()),
                           golden="oasis_ref", golden_traces=DG_GOLDEN_TRACES,
                           mismatches_vs_golden=vs_golden,
                           cxx_traces=len(traces), mismatches_vs_cxx=vs_cxx),
               kernel_vs_plain=file_twin,
               trials=metrics_cfg.num_trials, card_vs_cpu=stat_errs,
               cli_cpu=dict(run="the first trials, without spikes",
                            trials=DG_CPU_TRIALS, seconds=cpu_s,
                            stages_s=cpu_stages, plain_calls=cpu_calls,
                            spikes_differ=cpu_spike_diff),
               cli_cuda_vs_cpu_rel=cli_err),
           surrogate=dict(samples=SURROGATE_SAMPLES, shape=[6, 2],
                          generate_surrogate_data_s=surrogate_s,
                          training_rows=9192),
           mlp_run=dict(flags="--model mlp --algorithm gan", epochs=MLP_EPOCHS,
                        steps_per_epoch=8192 // 64, seconds=mlp_s,
                        train_epoch_s=[c["s"] for c in
                                       spy.calls["train_epoch"]],
                        generated_pkl_s=spy.calls[
                            "generate_surrogate_dataset"][0]["s"],
                        generated=list(generated.shape),
                        sampling_launches=mlp_launches,
                        sampled_traces=MLP_EPOCHS * 2, golden="oasis_ref",
                        mismatches_vs_golden=mlp_sample_diff,
                        kernel_vs_plain=mlp_sample_twin,
                        last_logs=mlp_logs[MLP_EPOCHS - 1]),
           gan_step_card_vs_cpu=versus)
    return dict(train_launches=train_launches,
                metrics_launches=metrics_launches, mlp_launches=mlp_launches)


def conv2d_flags(records, run, epochs, *extra):
    """The conv2d recipe's flags for ``calciumgan_tpu_torch.main``: the
    flagship's (``BASELINE.md:278-312``) with ``--model calciumgan2d`` at
    batch 64."""
    return ["--input_dir", records, "--output_dir", run,
            "--model", "calciumgan2d", "--batch_size", str(CONV2D_BATCH),
            "--num_units", "64", "--kernel_size", "24", "--strides", "2",
            "--m", "10", "--n", "2", "--layer_norm", "--mixed_precision",
            "--n_critic", "5", "--noise_dim", "32", "--algorithm", "wgan-gp",
            "--epochs", str(epochs), "--checkpoint_every", "1",
            "--seed", str(SEED), "--device", "cuda", "--verbose", "0",
            *extra]


def conv2d_config(frames=T, **kw):
    """The conv2d recipe's architecture at ``frames`` frames."""
    from calciumgan_tpu_torch.config import Config
    return Config(**dict(dict(
        model="calciumgan2d", algorithm="wgan-gp", sequence_length=frames,
        num_neurons=CLI_NEURONS, num_channels=1,
        signal_shape=(frames, CLI_NEURONS, 1), noise_dim=32, num_units=64,
        kernel_size=24, strides=2, m=10, n=2, layer_norm=True, n_critic=5,
        normalize=True, signals_min=0.0, signals_max=1.0,
        mixed_precision=True, seed=SEED), **kw))


def rungs_climbed(traces, machine: str = "oasis_ar1") -> int:
    """The launches of ``machine`` the dispatch makes on host ``traces``
    (N, T) on the card: the rungs of the depth ladder their batch climbs,
    as on the path that deconvolved them (the climb depends on the traces
    alone; ``oasis_ar1_long_precise`` for T > 4096)."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.eval.spike_eval import deconvolve_traces
    from calciumgan_tpu_torch.ops import oasis_cuda
    before = collections.Counter(oasis_cuda.launches)
    deconvolve_traces(torch.from_numpy(np.ascontiguousarray(
        traces, np.float32)).cuda())
    return launched(machine, oasis_cuda.launches - before)


def file_spikes_vs_references(filename, what: str) -> dict:
    """An epoch file's ``spikes`` against the C++ float64 kernel on every
    trace and the numpy golden on ``CONV2D_GOLDEN_TRACES`` of them; both
    must agree. Returns the findings and the file's traces (N*C, T)."""
    import numpy as np
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.utils import h5
    signals, spikes = h5.get(filename, "signals"), h5.get(filename, "spikes")
    check(spikes.dtype == np.int8 and spikes.shape == signals.shape
          and set(np.unique(spikes).tolist()) <= {0, 1},
          f"{what}: spikes {spikes.shape} {spikes.dtype}")
    traces = np.ascontiguousarray(signals.transpose(0, 2, 1)).reshape(-1, T)
    ours = np.ascontiguousarray(spikes.transpose(0, 2, 1)).reshape(-1, T)
    vs_cxx = int((ours != dispatch._exact_spikes_host(
        traces, G, S_MIN, THRESHOLD)).sum())
    pick = np.sort(np.random.default_rng(SEED).choice(
        len(traces), CONV2D_GOLDEN_TRACES, replace=False))
    vs_golden = int((ours[pick] != golden_spikes(traces[pick])).sum())
    check(vs_cxx == 0 and vs_golden == 0,
          f"{what}: {vs_cxx} spike mismatches vs the C++ float64 kernel, "
          f"{vs_golden} vs the golden")
    return dict(spikes=int(spikes.sum()), cxx_traces=len(traces),
                mismatches_vs_cxx=vs_cxx, golden="oasis_ref",
                golden_traces=CONV2D_GOLDEN_TRACES,
                mismatches_vs_golden=vs_golden), traces


def step2d_card_vs_cpu() -> dict:
    """One full-width ``calciumgan2d`` WGAN-GP step (units 64, kernel 24,
    102 neurons; 256 frames, batch 2, n_critic 1) from one state and the
    same draws on the card and on the CPU, float32 and bfloat16, at
    learning rate 0 (see :func:`step_card_vs_cpu`)."""
    import numpy as np
    B, n_critic = STEP2D_B, 1
    rng = np.random.default_rng(SEED + 71)
    noise = [rng.standard_normal((B, 32)).astype(np.float32)
             for _ in range(n_critic + 1)]
    alpha = [rng.random(B).astype(np.float32) for _ in range(n_critic)]
    # 7 shifts a critic pass: (time, neuron) on layers 0-2, neuron on 3;
    # within -2..2, both axes' range
    shifts = rng.integers(-2, 3, 7 * (2 * n_critic + 1)).tolist()
    real = rng.random((B, STEP2D_T, CLI_NEURONS, 1)).astype(np.float32)
    return steps_card_vs_cpu(
        lambda bf16: conv2d_config(
            STEP2D_T, mixed_precision=bf16, n_critic=n_critic,
            batch_size=B, learning_rate=0.0),
        real, (noise, alpha, shifts),
        ("loss/generator", "loss/discriminator", "loss/gradient_penalty"),
        bounds=STEP2D_BOUNDS)


def dilation_zero_flops(generator, batch: int, n_critic: int) -> int:
    """The products by zeros that ``FlopCounterMode`` counts in one WGAN-GP
    step of a 2-D generator: each transposed convolution runs as a stride-1
    convolution over its input dilated by the strides
    (``base._dilated_conv2d``), so it is counted ``sh*sw`` times its work,
    in each of the step's ``n_critic + 1`` forwards and in the generator
    step's backward (both gradients, twice a forward). The work is what
    ``F.conv_transpose2d`` is counted for the same layers (checked on the
    CPU against a step that runs them so)."""
    h, w = generator.w0, generator.c0
    zeros = 0
    for conv in generator.conv_transpose:
        c_in, c_out, kh, kw = conv.weight.shape
        sh, sw = conv.stride
        zeros += (sh * sw - 1) * 2 * batch * h * w * c_in * c_out * kh * kw
        h, w = h * sh, w * sw
    return zeros * (n_critic + 3)


def conv2d_layer_times() -> dict:
    """Which 2-D convolutions cuDNN runs slowly, by CUDA events at the
    conv2d recipe's widths (random weights and inputs, bf16): each
    generator layer at batch 64 as ``F.conv_transpose2d`` (one call: the
    slow ones take seconds) and in the port's dilated form (after a
    warm-up), and each critic layer at 128 rows, its forward and its
    forward with the gradient of its input (the penalty's and the
    generator step's), after a warm-up."""
    import torch
    import torch.nn.functional as F
    from calciumgan_tpu_torch.models import get_models

    def once(fn, warm: bool) -> float:
        if warm:
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    cfg = conv2d_config(batch_size=CONV2D_BATCH)
    gen, dis = get_models(cfg, rng=torch.Generator().manual_seed(SEED),
                          device="cuda")
    found = {}
    with torch.no_grad():
        x = torch.randn(CONV2D_BATCH, cfg.noise_dim, gen.w0, gen.c0,
                        device="cuda", dtype=torch.bfloat16)
        for i, conv in enumerate(gen.conv_transpose):
            w = conv.weight.to(torch.bfloat16)
            found[f"generator {i} {list(x.shape)}"] = dict(
                conv_transpose2d_ms=once(lambda: F.conv_transpose2d(
                    x, w, stride=conv.stride), warm=False),
                dilated_ms=once(lambda: conv(x), warm=True))
            x = conv(x)
    x = torch.rand(2 * CONV2D_BATCH, 1, T, CLI_NEURONS, device="cuda",
                   dtype=torch.bfloat16)
    for i, conv in enumerate(dis.conv):
        x = x.detach().requires_grad_(True)
        y = conv(x)
        grad = torch.randn_like(y)
        found[f"critic {i} {list(x.shape)}"] = dict(
            forward_ms=once(lambda: conv(x), warm=True),
            with_input_gradient_ms=once(lambda: torch.autograd.grad(
                conv(x), x, grad), warm=True))
        x = y
    return found


def time_conv2d_step(signals, smi, work) -> dict:
    """The conv2d recipe's step at batch 64 (n_critic 5), after the phase's
    run has warmed cuDNN and the allocator: one step under
    ``torch.profiler`` and ``FlopCounterMode`` timed by CUDA events, its
    FLOPs as run and as work (without the dilation's zeros) against the
    bf16 peak, the device's busy share and the kernels that took the most
    device time."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.algorithms import get_algorithm
    from calciumgan_tpu_torch.algorithms.gan import Draws
    from calciumgan_tpu_torch.data.pipeline import DeviceStore
    from calciumgan_tpu_torch.models import get_models
    cfg = conv2d_config(batch_size=CONV2D_BATCH)
    dev = torch.device("cuda")
    algo = get_algorithm(cfg, *get_models(
        cfg, rng=torch.Generator().manual_seed(SEED), device=dev))
    state = algo.init_state()
    real = DeviceStore(signals[:CONV2D_BATCH], dev).batch(
        list(range(CONV2D_BATCH)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = FlopCounterMode(display=False)
    counted.mod_tracker = _NoModuleTracker()
    window = train._ProfileWindow(os.path.join(work, "profile2d"), dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with counted:
        start.record()
        algo.train_step(state, real, Draws(SEED, 0, dev))
        end.record()
    window.steps = 1
    profile = window.stop()
    ms = start.elapsed_time(end)
    flops = counted.get_total_flops()
    work_flops = flops - dilation_zero_flops(algo.generator, CONV2D_BATCH,
                                             cfg.n_critic)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bound_ms = work_flops / BF16_FLOPS_PER_S * 1e3
    return dict(card=smi, batch=CONV2D_BATCH, step_ms=ms,
                flops_as_run=flops, flops_per_step=work_flops,
                bound_ms=bound_ms, bf16_peak_share=bound_ms / ms,
                peak_memory_gb=peak_gb, profiled_step=profile)


def phase_conv2d(smi, work, recording, versus=None):
    """This slice's path at full width: phase 5's recording through
    ``generate_tfrecords --conv2d``, ``main --model calciumgan2d`` at the
    conv2d recipe for 1 epoch with ``--save_generated last`` and again
    (resumed, nothing left to train), ``compute_metrics --device cuda`` on
    that run and ``generate --spikes`` from its newest checkpoint; one
    full-width 2-D step on the card against the CPU
    (:func:`step2d_card_vs_cpu`, unless ``versus`` holds its findings); the
    step's time, FLOPs and kernels."""
    import pickle

    import numpy as np
    import torch
    from calciumgan_tpu_torch import compute_metrics
    from calciumgan_tpu_torch import generate as generate_mod
    from calciumgan_tpu_torch import main as train_main
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.config import Config
    from calciumgan_tpu_torch.data import pipeline
    from calciumgan_tpu_torch.dataset import generate_tfrecords
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    from calciumgan_tpu_torch.utils import h5, io
    C = CLI_NEURONS
    root = os.path.join(work, "conv2d")
    os.makedirs(root)
    pkl, records = os.path.join(root, "rec.pkl"), os.path.join(root, "rec")
    run = os.path.join(root, "run")
    with open(pkl, "wb") as f:
        pickle.dump({k: np.concatenate([v[:2], v]) for k, v in
                     ((k, np.asarray(recording[k], np.float32))
                      for k in ("signals", "oasis"))}, f)
    start = time.perf_counter()
    generate_tfrecords.cli([
        "--input", pkl, "--output_dir", records, "--sequence_length", str(T),
        "--stride", str(CONV2D_STRIDE), "--normalize", "--conv2d",
        "--validation_size", str(CONV2D_VAL_ROWS), "--verbose", "0"])
    records_s = time.perf_counter() - start
    info = pipeline.load_info(records)
    check(info["signal_shape"] == (T, C, 1) and info["num_channels"] == 1
          and info["conv2d"] and info["validation_size"] == CONV2D_VAL_ROWS
          and info["train_size"] >= CONV2D_BATCH,
          f"conv2d records: {info['signal_shape']}, {info['train_size']} + "
          f"{info['validation_size']}")

    # 1. training: the sampling epoch runs the kernel; a rerun resumes
    # from its checkpoint and finds the run done
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    spy = Spy(train, "train_epoch", "validate_epoch", "sample_and_plot",
              "make_batch_sources")
    flags = conv2d_flags(records, run, CONV2D_EPOCHS, "--save_generated",
                         "last")
    start = time.perf_counter()
    with spy:
        train_main.cli(flags)
    train_s = time.perf_counter() - start
    launches, calls = dict(oasis_cuda.launches), oasis_torch.calls
    check(set(launches) == {"oasis_ar1/shared"}
          and launches["oasis_ar1/shared"] >= CONV2D_EPOCHS and calls == 0,
          f"conv2d sampling epochs launched {launches}, plain calls {calls}")
    logs = [c["out"] for c in spy.calls["train_epoch"]
            + spy.calls["validate_epoch"]]
    check(len(logs) == 2 * CONV2D_EPOCHS
          and all(np.isfinite(v) for d in logs for v in d.values()),
          f"conv2d training: non-finite losses {logs}")
    samples = spy.calls["sample_and_plot"]
    check(len(samples) == CONV2D_EPOCHS,
          f"{len(samples)} conv2d sampling epochs")
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
    with Spy(train, "train_epoch", "sample_and_plot") as rerun:
        train_main.cli(flags)
    check(not rerun.calls["train_epoch"]
          and not rerun.calls["sample_and_plot"]
          and sorted(os.listdir(os.path.join(run, "checkpoints"))) == ckpts,
          f"conv2d rerun: {len(rerun.calls['train_epoch'])} epochs trained,"
          f" checkpoints {ckpts}")
    sample_diff = sampled_vs_golden(samples, (C, T), "conv2d sampling epochs")
    last_sample = samples[-1]["out"][0]
    sample_twin = hold_to_twin(last_sample, rungs_climbed(last_sample),
                               "conv2d sampling epoch")
    cfg = Config(output_dir=run, verbose=0).load()
    check(cfg.model == "calciumgan2d" and cfg.signal_shape == (T, C, 1),
          f"conv2d run: {cfg.model} {cfg.signal_shape}")
    last = CONV2D_EPOCHS - 1
    fake_file = io.load_generated_info(cfg)[last]["filename"]
    check(h5.get_shape(fake_file, "signals") == (CONV2D_VAL_ROWS, T, C),
          f"conv2d epoch file {h5.get_shape(fake_file, 'signals')}")
    train_signals = spy.calls["make_batch_sources"][0]["args"][1].signals

    # 2. compute_metrics on the run
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    config, options = compute_metrics.parse_args(
        ["--output_dir", run, "--device", "cuda", "--verbose", "0",
         "--seed", str(SEED)])
    stages = {}
    start = time.perf_counter()
    results = compute_metrics.main(config, seconds=stages, **options)
    torch.cuda.synchronize()
    metrics_s = time.perf_counter() - start
    metrics_launches = dict(oasis_cuda.launches)
    check(set(metrics_launches) == {"oasis_ar1/shared"}
          and oasis_torch.calls == 0,
          f"compute_metrics launched {metrics_launches}, plain calls "
          f"{oasis_torch.calls}")
    check(list(results) == [last] and all(np.isfinite(v)
                                          for v in results[last].values()),
          f"conv2d KLs of synthetic data: {results}")
    file_found, traces = file_spikes_vs_references(fake_file,
                                                   "conv2d epoch file")
    file_twin = hold_to_twin(traces, launched("oasis_ar1", metrics_launches),
                             "conv2d epoch file")

    # 3. generate --spikes from the newest checkpoint
    out = os.path.join(root, "samples" + h5.default_suffix(verbose=False))
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    start = time.perf_counter()
    generate_mod.cli(["--output_dir", run, "--num_samples",
                      str(CONV2D_SERVED), "--batch_size", str(CONV2D_SERVED),
                      "--spikes", "--device", "cuda", "--out", out,
                      "--verbose", "0"])
    serve_s = time.perf_counter() - start
    serve_launches = dict(oasis_cuda.launches)
    check(set(serve_launches) == {"oasis_ar1/shared"}
          and oasis_torch.calls == 0,
          f"generate --spikes launched {serve_launches}, plain calls "
          f"{oasis_torch.calls}")
    served = h5.get(out, "signals")
    check(served.shape == (CONV2D_SERVED, T, C)
          and bool(np.isfinite(served).all()),
          f"generate --spikes: signals {served.shape}")
    served_found, served_traces = file_spikes_vs_references(
        out, "generate --spikes")
    served_twin = hold_to_twin(served_traces,
                               launched("oasis_ar1", serve_launches),
                               "generate --spikes")

    # 4. the step on the card against the CPU, then its time and kernels
    if versus is None:
        versus = step2d_card_vs_cpu()
    timing = time_conv2d_step(np.asarray(train_signals), smi, root)
    layers = conv2d_layer_times()
    torch.cuda.synchronize()
    report("phase 10 conv2d", card=smi,
           records=dict(windows=info["train_size"] + info["validation_size"],
                        train=info["train_size"],
                        validation=info["validation_size"],
                        stride=CONV2D_STRIDE, shape=[T, C, 1],
                        generate_tfrecords_s=records_s),
           run=dict(flags="conv2d recipe: calciumgan2d, wgan-gp, batch 64, "
                          "units 64, kernel 24, m 10, n 2, layer_norm, bf16,"
                          " --save_generated last",
                    epochs=CONV2D_EPOCHS, seconds=train_s,
                    train_epoch_s=[c["s"] for c in spy.calls["train_epoch"]],
                    train_logs=logs[:CONV2D_EPOCHS],
                    validation_logs=logs[CONV2D_EPOCHS:],
                    rerun=dict(epochs_trained=0, checkpoints=ckpts),
                    sampling_launches=launches, plain_calls=calls,
                    sampled_traces=CONV2D_EPOCHS * C, golden="oasis_ref",
                    mismatches_vs_golden=sample_diff,
                    kernel_vs_plain=sample_twin,
                    epoch_file=[CONV2D_VAL_ROWS, T, C]),
           compute_metrics=dict(of_seeded_synthetic_data=results[last],
                                seconds=metrics_s, stages_s=stages,
                                launches=metrics_launches,
                                epoch_file_spikes=file_found,
                                kernel_vs_plain=file_twin),
           generate=dict(samples=CONV2D_SERVED, seconds=serve_s,
                         launches=serve_launches, spikes=served_found,
                         kernel_vs_plain=served_twin),
           card_vs_cpu=dict(cut=f"{STEP2D_T} frames, batch {STEP2D_B}, "
                                f"n_critic 1, learning rate 0",
                            **versus),
           step=timing, layers_ms=layers)
    return dict(train_launches=launches, metrics_launches=metrics_launches,
                serve_launches=serve_launches, timing=timing)


def bn_step_card_vs_cpu(signals) -> dict:
    """One vanilla-GAN step of the flagship with ``--batch_norm`` (batch 8,
    learning rate 0) from one state and the same noise and shifts on the
    card and on the CPU, float32 and bfloat16: losses, gradients and the
    running statistics its one training pass moved."""
    import dataclasses

    import numpy as np
    B = 8
    rng = np.random.default_rng(SEED + 81)
    noise = [rng.standard_normal((B, 32)).astype(np.float32)]
    shifts = rng.integers(-10, 11, 4).tolist()
    return steps_card_vs_cpu(
        lambda bf16: dataclasses.replace(
            flagship_config(), algorithm="gan", batch_norm=True,
            mixed_precision=bf16, batch_size=B, learning_rate=0.0),
        np.ascontiguousarray(signals[:B]), (noise, [], shifts),
        ("loss/generator", "loss/discriminator"),
        bounds=dict(f32_grad=BN_STEP_F32_GRAD_TOL))


def phase_batch_norm(smi, work, records, signals):
    """BatchNorm: ``main --batch_norm --layer_norm --algorithm gan --ema
    0.999`` on phase 6's flagship records for 2 epochs; the running
    statistics it stored; ``generate`` serving the EMA parameters with them
    (equal to ``GAN.sample``, and not what mean 0 and variance 1 give); one
    step on the card against the CPU."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch import generate as generate_mod
    from calciumgan_tpu_torch import main as train_main
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.algorithms import gan, get_algorithm
    from calciumgan_tpu_torch.algorithms.gan import Draws
    from calciumgan_tpu_torch.config import Config
    from calciumgan_tpu_torch.models import get_models
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    from calciumgan_tpu_torch.utils import checkpoint
    run = os.path.join(work, "bn_run")
    ckpt_dir = os.path.join(run, "checkpoints")
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    spy = Spy(train, "train_epoch", "validate_epoch", "sample_and_plot")
    start = time.perf_counter()
    with spy:
        train_main.cli(train_flags(records, run, 2, "--batch_norm",
                                   "--algorithm", "gan", "--ema", "0.999"))
    train_s = time.perf_counter() - start
    launches, calls = dict(oasis_cuda.launches), oasis_torch.calls
    check(set(launches) == {"oasis_ar1/shared"}
          and launches["oasis_ar1/shared"] >= 2 and calls == 0,
          f"BatchNorm sampling epochs launched {launches}, plain calls "
          f"{calls}")
    logs = [c["out"] for c in spy.calls["train_epoch"]
            + spy.calls["validate_epoch"]]
    check(len(logs) == 4 and all(np.isfinite(v) for d in logs
                                 for v in d.values())
          and "loss/gradient_penalty" not in logs[0],
          f"BatchNorm training: {logs}")
    samples = spy.calls["sample_and_plot"]
    sample_diff = sampled_vs_golden(samples, (102, T),
                                    "BatchNorm sampling epochs")
    last_sample = samples[-1]["out"][0]
    sample_twin = hold_to_twin(last_sample, rungs_climbed(last_sample),
                               "BatchNorm sampling epoch")

    # the running statistics the run stored: finite, moved from (0, 1)
    stored = torch.load(checkpoint.port_checkpoint_path(ckpt_dir, 1),
                        map_location="cpu", weights_only=True)
    stats = {k: v for k, v in stored["generator"]["params"].items()
             if k.endswith((".mean", ".var"))}
    moved = {k: float((v - float(k.endswith(".var"))).abs().max())
             for k, v in stats.items()}
    check(len(stats) == 10 and all(bool(torch.isfinite(v).all())
                                   for v in stats.values())
          and min(moved.values()) > 0.0 and stored["ema"] is not None
          and not any(k in stored["ema"] for k in stats),
          f"stored running statistics: moved {moved}")

    # generate serves the EMA parameters with those statistics
    cfg = Config(output_dir=run, verbose=0).load()
    algo = get_algorithm(cfg, *get_models(cfg, device="cuda"))
    state = algo.init_state()
    checkpoint.restore(ckpt_dir, state, verbose=0)
    noise = Draws(SEED, 0, "cuda").noise(16, cfg.noise_dim)
    variables, epoch = checkpoint.restore_generator_params(
        ckpt_dir, ema=True, model=cfg.model)
    served = gan.generate(generate_mod.build_generator(cfg, variables,
                                                       "cuda"), noise)
    sampled = algo.sample(state, noise)
    served_vs_sample = float((served - sampled).abs().max())
    fresh = dict(variables, batch_stats={
        group: {"BatchNorm_0": {
            "mean": np.zeros_like(norm["BatchNorm_0"]["mean"]),
            "var": np.ones_like(norm["BatchNorm_0"]["var"])}}
        for group, norm in variables["batch_stats"].items()})
    stale = gan.generate(generate_mod.build_generator(cfg, fresh, "cuda"),
                         noise)
    stale_gap = float((stale - sampled).abs().max())
    raw, _ = checkpoint.restore_generator_params(ckpt_dir, ema=False,
                                                 model=cfg.model)
    raw_gap = float((gan.generate(generate_mod.build_generator(
        cfg, raw, "cuda"), noise) - sampled).abs().max())
    check(epoch == 1 and served_vs_sample == 0.0 and stale_gap > 1e-3
          and raw_gap > 0.0,
          f"generate: {served_vs_sample} from GAN.sample, {stale_gap} with "
          f"mean 0 and variance 1, {raw_gap} with the raw parameters")
    versus = bn_step_card_vs_cpu(signals)
    torch.cuda.synchronize()
    report("phase 11 BatchNorm", card=smi,
           run=dict(flags="flagship recipe, --batch_norm --algorithm gan "
                          "--ema 0.999", epochs=2, seconds=train_s,
                    train_epoch_s=[c["s"] for c in spy.calls["train_epoch"]],
                    last_logs=logs[1], sampling_launches=launches,
                    plain_calls=calls, sampled_traces=2 * 102,
                    golden="oasis_ref", mismatches_vs_golden=sample_diff,
                    kernel_vs_plain=sample_twin),
           running_statistics=dict(buffers=len(stats),
                                   moved_from_init=moved),
           generate=dict(epoch=epoch, served_vs_gan_sample=served_vs_sample,
                         with_mean_0_var_1=stale_gap,
                         with_raw_parameters=raw_gap),
           card_vs_cpu=versus)
    return dict(train_launches=launches)


def phase_in_graph(smi, config, variables):
    """The in-graph API: ``deconvolve_signals`` on one serving batch of
    generated traces (phase 4's, 1024 x 102 of 2048 frames) on the card,
    with its kernel launches, flagged rows and host-to-host seconds; the
    kernel at the API's setting (depth 128, merge budget 4, no band) against
    its plain version bit for bit and timed; the redo path forced by depth
    8 on a few hundred rows, whose flagged rows, and no other, take
    ``oasis_ar1_while``'s spikes; ``oasis_ar1_while`` on the card against
    the CPU and the float64 golden (mismatches reported: a float32 decision
    within rounding of its margin may go either way), and timed."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.algorithms import gan
    from calciumgan_tpu_torch.generate import build_generator
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    dev = torch.device("cuda")
    generator = build_generator(config, variables, dev)
    noise = gan.get_noise(torch.Generator(device=dev).manual_seed(SEED),
                          BATCH, config.noise_dim, dev)
    with torch.no_grad():
        traces = gan.generate(generator, noise).transpose(1, 2).contiguous()
    traces = traces.reshape(-1, T)  # (1024*102, 2048) as phase 4's
    B = traces.shape[0]
    torch.cuda.synchronize()

    # the main path: counts at 0, one call, counts read
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    spy = Spy(dispatch, "oasis_ar1_while")
    start = time.perf_counter()
    with spy:
        spikes = dispatch.deconvolve_signals(traces)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches, calls = dict(oasis_cuda.launches), oasis_torch.calls
    while_rows = [int(c["args"][0].shape[0]) for c in spy.calls[
        "oasis_ar1_while"]]
    check(spikes.shape == traces.shape and spikes.dtype == torch.float32
          and spikes.is_cuda and bool(((spikes == 0) | (spikes == 1)).all()),
          f"in-graph spikes {tuple(spikes.shape)} {spikes.dtype}")
    check(launches == {"oasis_ar1/shared": 1} and calls == 0,
          f"in-graph launches {launches}, plain calls {calls}")

    # the same composition rebuilt: kernel rows where redo is 0, the while
    # machine's where it is not
    api = dict(g=G, lam=0.0, s_min=S_MIN, depth=None,
               merge_attempts=dispatch._IN_GRAPH_MERGE_ATTEMPTS,
               flag_tol=0.0)
    _, s_k, redo = oasis_cuda.oasis_ar1_cuda(traces, **api)
    flagged = torch.nonzero(redo).squeeze(1)
    check(while_rows == ([len(flagged)] if len(flagged) else []),
          f"the while machine saw {while_rows} rows, {len(flagged)} flagged")
    expect = (s_k > THRESHOLD).float()
    if len(flagged):
        expect[flagged] = (dispatch.oasis_ar1_while(
            traces[flagged], g=G, s_min=S_MIN)[1] > THRESHOLD).float()
    differ = int((spikes != expect).any(1).sum())
    check(differ == 0, f"in-graph spikes differ from kernel + while on "
                       f"{differ} rows")
    flags = redo.cpu().numpy()
    host = dispatch.deconvolve_signals_host(traces)
    vs_host = int((spikes.to(torch.int8).cpu().numpy() != host).sum())

    # the kernel at the in-graph setting against its plain version
    held = compare_kernel(traces, **dict(api, depth=128))
    check_equal(held, "classic, depth 128, merge budget 4")
    check_variant(held, "oasis_ar1/shared", "classic, depth 128")
    kernel_ms = cuda_ms(lambda: oasis_cuda.oasis_ar1_cuda(traces, **api),
                        reps=5)

    # the redo path forced: depth 8 on a few hundred rows
    rows = traces[:FORCED_ROWS]
    _, s8, redo8 = oasis_cuda.oasis_ar1_cuda(rows, **dict(api, depth=8))
    flagged8 = torch.nonzero(redo8).squeeze(1)
    with Spy(dispatch, "oasis_ar1_while") as forced:
        out8 = dispatch.deconvolve_signals(rows, depth=8)
    seen = [c["args"][0] for c in forced.calls["oasis_ar1_while"]]
    check(len(seen) == 1 and torch.equal(seen[0], rows[flagged8]),
          f"forced redo: the while machine saw {[len(s) for s in seen]} "
          f"rows, {len(flagged8)} flagged")
    s_w = dispatch.oasis_ar1_while(rows[flagged8], g=G, s_min=S_MIN)[1]
    keep = torch.ones(len(rows), dtype=torch.bool, device=dev)
    keep[flagged8] = False
    check(torch.equal(out8[flagged8], (s_w > THRESHOLD).float())
          and torch.equal(out8[keep], (s8[keep] > THRESHOLD).float()),
          "forced redo: flagged rows differ from oasis_ar1_while's")
    vs_while = int((out8 != dispatch.deconvolve_signals(
        rows, backend="while")).sum())

    # oasis_ar1_while on the card against the CPU and the float64 golden
    pick = np.sort(np.random.default_rng(SEED).choice(B, WHILE_CPU_ROWS,
                                                      replace=False))
    sample = traces[torch.from_numpy(pick).to(dev)]
    c_card, s_card = dispatch.oasis_ar1_while(sample, g=G, s_min=S_MIN)
    host_rows = sample.cpu()
    c_cpu, s_cpu = dispatch.oasis_ar1_while(host_rows, g=G, s_min=S_MIN)
    c_card, s_card = c_card.cpu(), s_card.cpu()
    spk_card = (s_card > THRESHOLD).numpy().astype(np.int8)
    spk_cpu = (s_cpu > THRESHOLD).numpy().astype(np.int8)
    gold = golden_spikes(host_rows[:WHILE_GOLDEN_ROWS].numpy())
    while_vs = dict(
        rows=WHILE_CPU_ROWS,
        card_vs_cpu=dict(c_max_abs=float((c_card - c_cpu).abs().max()),
                         s_max_abs=float((s_card - s_cpu).abs().max()),
                         c_lanes_differ=int((c_card != c_cpu).any(1).sum()),
                         spike_mismatches=int((spk_card != spk_cpu).sum())),
        golden_rows=WHILE_GOLDEN_ROWS, golden="oasis_ref",
        card_vs_golden=int((spk_card[:WHILE_GOLDEN_ROWS] != gold).sum()),
        cpu_vs_golden=int((spk_cpu[:WHILE_GOLDEN_ROWS] != gold).sum()),
        golden_spikes=int(gold.sum()))
    check(c_card.shape == c_cpu.shape == sample.shape
          and bool(torch.isfinite(c_card).all())
          and bool(torch.isfinite(c_cpu).all()),
          f"oasis_ar1_while card vs CPU: {while_vs['card_vs_cpu']}")
    while_ms = {n: cuda_ms(lambda n=n: dispatch.oasis_ar1_while(
        traces[:n], g=G, s_min=S_MIN), reps=1) for n in WHILE_TIMED_ROWS}
    torch.cuda.synchronize()
    report("phase 12 in-graph deconvolve_signals", card=smi,
           shape=[B, T], seconds=seconds, launches=launches,
           plain_calls=calls, flagged=int(len(flagged)),
           flagged_bits={f"bit{b}": int(((flags >> b) & 1).sum())
                         for b in range(3)},
           while_rows=while_rows, spikes=int(spikes.sum()),
           vs_host_dispatch=dict(mismatches=vs_host,
                                 note="the host dispatch recomputes "
                                      "borderline rows in float64"),
           kernel_depth128_budget4=dict(strip(held), ms=kernel_ms,
                                        **bound(B, T, False)),
           forced_redo=dict(rows=FORCED_ROWS, depth=8,
                            flagged=int(len(flagged8)),
                            spikes_vs_while_backend=vs_while),
           oasis_ar1_while=while_vs,
           while_ms={str(n): ms for n, ms in while_ms.items()})
    return dict(launches=launches, kernel_ms=kernel_ms,
                plain_ms=held["plain_ms"], max_abs_err=held["max_abs_err"])


def phase_sweep(smi, work, records):
    """The sweep: ``python -m calciumgan_tpu_torch.search --device cuda``
    in-process with two points of the default grid on phase 6's records,
    batch 64, 2 epochs: two ``results.jsonl`` lines with finite metrics, the
    ``_hparams_`` events, the OASIS launches of each experiment's sampling
    epochs (and their spikes against the float64 golden); a rerun that
    skips both and leaves the results as they were; ``--summarize``;
    ``--parallel 2`` refused on one GPU."""
    import contextlib
    import glob
    import io

    import numpy as np
    import torch
    from calciumgan_tpu_torch import search, train
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    out = os.path.join(work, "sweep")
    argv = ["--input_dir", records, "--output_dir", out, "--batch_size",
            "64", "--epochs", str(SWEEP_EPOCHS), "--device", "cuda",
            "--grid", json.dumps(SWEEP_GRID)]
    per_experiment = {}
    run_experiment = search.run_experiment

    def counted(config, session, params, **kw):
        before = collections.Counter(oasis_cuda.launches)
        start = time.perf_counter()
        metrics = run_experiment(config, session, params, **kw)
        per_experiment[session] = dict(
            seconds=time.perf_counter() - start,
            launches=dict(collections.Counter(oasis_cuda.launches) - before))
        return metrics

    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    text = io.StringIO()
    search.run_experiment = counted
    try:
        with Spy(train, "sample_and_plot") as spy, \
                contextlib.redirect_stdout(text):
            start = time.perf_counter()
            search.main(argv)
            sweep_s = time.perf_counter() - start
    finally:
        search.run_experiment = run_experiment
    launches, calls = dict(oasis_cuda.launches), oasis_torch.calls
    check("ERROR" not in text.getvalue(), f"sweep: {text.getvalue()}")
    with open(os.path.join(out, "results.jsonl")) as f:
        results = f.read()
    lines = [json.loads(line) for line in results.splitlines()]
    check([line["session"] for line in lines] == [1, 2]
          and all(np.isfinite(list(line["metrics"].values())).all()
                  and "signals_metrics/mean" in line["metrics"]
                  for line in lines), f"sweep results: {lines}")
    check(sorted(per_experiment) == [1, 2] and all(
        set(e["launches"]) == {"oasis_ar1/shared"}
        for e in per_experiment.values()) and calls == 0,
        f"sweep launches {per_experiment}, plain calls {calls}")
    sampled = sampled_vs_golden(spy.calls["sample_and_plot"], (102, T),
                                "sweep sampling epochs")
    events = {}
    for name in glob.glob(os.path.join(out, "**", "events.out.tfevents.*"),
                          recursive=True):
        with open(name, "rb") as f:
            events[os.path.relpath(name, out)] = f.read()
    blob = b"".join(events.values())
    check(blob.count(b"_hparams_/experiment") == 1
          and blob.count(b"_hparams_/session_start_info") == 2
          and blob.count(b"test/signals_metrics/mean") >= 3,
          f"sweep events: {sorted(events)}")

    # resume: both skipped, results unchanged
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        search.main(argv)
    with open(os.path.join(out, "results.jsonl")) as f:
        rerun_same = f.read() == results
    skipped = text.getvalue().count("already exists")
    check(skipped == 2 and rerun_same, f"sweep rerun: {skipped} skipped, "
                                       f"results unchanged {rerun_same}")
    with contextlib.redirect_stdout(io.StringIO()):
        ranked = search.main(["--output_dir", out, "--summarize"])
    means = [r["metrics"]["signals_metrics/mean"] for r in ranked]
    check(len(ranked) == 2 and means == sorted(means),
          f"--summarize: {means}")
    # --parallel 2 wants an even number of GPUs: refused on one card, as
    # the JAX package refuses it on one device
    count = torch.cuda.device_count()
    refused = "not run: an even number of GPUs"
    if count % 2:
        try:
            search.main(argv[:2] + ["--output_dir", os.path.join(
                work, "sweep_parallel")] + argv[4:] + ["--parallel", "2"])
            refused = None
        except ValueError as exc:
            refused = str(exc)
        check(refused == f"{count} devices not divisible by --parallel 2",
              f"--parallel 2 on {count} GPU(s): {refused}")
    torch.cuda.synchronize()
    report("phase 13 sweep", card=smi, grid=SWEEP_GRID, batch_size=64,
           epochs=SWEEP_EPOCHS, records=dict(train=TRAIN_ROWS,
                                             validation=VAL_ROWS),
           seconds=sweep_s, experiments={
               str(s): dict(e, metrics=lines[s - 1]["metrics"])
               for s, e in sorted(per_experiment.items())},
           launches=launches, plain_calls=calls,
           sampled_mismatches_vs_golden=sampled, event_files=sorted(events),
           rerun_skipped=skipped, summarize=[r["session"] for r in ranked],
           parallel_2=refused)
    return dict(launches=launches)


def _flagship_steps(real, dev, rank: int, world: int, moments: bool):
    """One flagship WGAN-GP step at learning rate 0 (every gradient taken
    at the seeded weights) in float32 (TF32 off) and bfloat16, on rank
    ``rank``'s rows of the global batch ``real`` with its share of the
    draws ``Draws(SEED, 0)``: the logs and, with ``moments``, Adam's first
    moments on the host."""
    import dataclasses

    import torch
    from calciumgan_tpu_torch.algorithms import get_algorithm
    from calciumgan_tpu_torch.algorithms.gan import Draws, shard_draws
    from calciumgan_tpu_torch.models import get_models
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    local = mesh_lib.rows_of(real, rank, world)
    found = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        cfg = dataclasses.replace(flagship_config(), mixed_precision=bf16,
                                  batch_size=len(real), learning_rate=0.0)
        algo = get_algorithm(cfg, *get_models(
            cfg, rng=torch.Generator().manual_seed(SEED), device=dev))
        state = algo.init_state()
        logs = algo.train_step(state, torch.from_numpy(local).to(dev),
                               shard_draws(Draws(SEED, 0, dev), rank, world,
                                           len(local)))
        found[name] = dict(logs={k: float(v) for k, v in logs.items()})
        if moments:
            found[name]["moments"] = {
                net: [getattr(state, net).optimizer.state[p][
                    "exp_avg"].cpu().numpy() for p in getattr(
                        state, net).module.parameters()]
                for net in ("generator", "discriminator")}
        del algo, state
    torch.cuda.empty_cache()
    return found


def _dp_rank(config, layout, real, sliced=None):
    """One of phase 14's ranks on ``cuda:0`` (gloo): the flagship step on
    its rows of ``real`` (and, given the ``sliced`` layout of
    ``--dcn_slices``, the step in its place there, ``dcn_steps``), then
    ``train.main`` over ``layout`` with its sampling epochs' OASIS
    launches, sampled traces, epoch seconds, and a digest of the bytes it
    ends with (parameters, running statistics, Adam's moments)."""
    import torch
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = mesh_lib.process_index()
    steps = _flagship_steps(real, layout.device, rank,
                            mesh_lib.process_count(), moments=rank == 0)
    dcn_steps = None
    if sliced is not None:
        mesh_lib.init_groups(sliced)
        dcn_steps, _ = _layout_steps(real, sliced.device, T, 10,
                                     ("f32", "bf16"))
        mesh_lib.forget_groups()
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    mesh_lib.collectives.clear()
    with Spy(train, "sample_and_plot", "train_epoch", "test") as spy:
        metrics = train.main(config, return_metrics=True, mesh=layout)
    torch.cuda.synchronize()
    launches, calls = dict(oasis_cuda.launches), oasis_torch.calls
    collectives = dict(mesh_lib.collectives)
    state = spy.calls["test"][0]["args"][3]
    tensors = [t for net in (state.generator, state.discriminator)
               for t in [*net.module.parameters(), *net.module.buffers(),
                         *(net.optimizer.state[p][k]
                           for p in net.module.parameters()
                           for k in ("exp_avg", "exp_avg_sq"))]]
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().cpu().numpy().tobytes())
    return dict(rank=rank, steps=steps, dcn_steps=dcn_steps, metrics=metrics,
                launches=launches, plain_calls=calls,
                collectives=collectives, digest=digest.hexdigest(),
                samples=[c["out"] for c in spy.calls["sample_and_plot"]],
                epoch_s=[c["s"] for c in spy.calls["train_epoch"]])


def _dp_scaling(real, layout, loop=DP_SCALING) -> dict:
    """Phase 15's step loop (:func:`_par_step_loop`, ``loop``'s windows:
    phase 14's ``DP_SCALING`` by default) of the flagship recipe on one GPU
    in this process (no group, as a one-GPU run trains) and over NCCL on
    the GPUs of the data-axis ``layout`` (slices folded in) through the
    library's launcher (:func:`_loop_rank`), in the order 1, P, P, 1: rank
    0's rates by launch, their median, least and most
    (:func:`_median_rates`), and the medians' ratio."""
    import torch
    from calciumgan_tpu_torch.parallel import launch as launch_lib
    count = len(layout.devices)
    rates = {1: [], count: []}
    for world in (1, count, count, 1):
        if world == 1:
            found = _par_step_loop(torch.device("cuda:0"), real, T, 10, loop)
        else:
            found = launch_lib.launch(
                _loop_rank, layout.devices, "nccl",
                args=(layout, real, loop), timeout=DP_TIMEOUT_S)[0]
        rates[world].append(found["rates"])
    out = {str(world): dict(_median_rates(runs),
                            timed_steps=sum(map(len, runs)) * loop[0],
                            rows_a_rank=len(real) // world)
           for world, runs in rates.items()}
    out["speedup_of_medians"] = out[str(count)]["median"] / out["1"]["median"]
    return out


def _loop_rank(layout, real, loop) -> dict:
    """A rank of a scaling run (:func:`_dp_scaling`): :func:`_par_step_loop`
    of the flagship recipe on its rows of ``real`` in ``loop``'s
    windows."""
    import torch
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_lib.init_groups(layout)
    return _par_step_loop(layout.device, real, T, 10, loop)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _step_vs_one_process(one, ranks, precisions=("f32", "bf16"),
                         key="steps") -> dict:
    """The ranks' step under ``key`` (rank 0's moments; the flagship step
    by default) against the one-process step on the same draws, held to
    phase 6's card-vs-CPU bounds: the logs and each net's largest gradient
    difference over its largest moment, in each of ``precisions``."""
    import numpy as np
    bounds = {"f32": (STEP_F32_LOSS_RTOL, STEP_F32_LOSS_ATOL,
                      STEP_F32_GRAD_TOL),
              "bf16": (STEP_BF16_LOSS_RTOL, STEP_BF16_LOSS_ATOL,
                       STEP_BF16_GRAD_TOL)}
    step = {}
    for name in precisions:
        rtol, atol, grad_tol = bounds[name]
        ref, got = one[name], ranks[0][key][name]
        loss_err = {k: abs(got["logs"][k] - v) for k, v in
                    ref["logs"].items()}
        grad_err = {}
        for net, pairs in ref["moments"].items():
            scale = max(float(np.abs(b).max()) for b in pairs)
            grad_err[net] = max(float(np.abs(a - b).max()) for a, b in zip(
                got["moments"][net], pairs)) / scale
        check(all(r[key][name]["logs"] == got["logs"] for r in ranks),
              f"{name} step: the ranks log differently")
        check(all(err <= rtol * abs(ref["logs"][k]) + atol
                  for k, err in loss_err.items()),
              f"{name} step: {len(ranks)} ranks vs 1 process, losses "
              f"{loss_err}")
        check(all(err <= grad_tol for err in grad_err.values()),
              f"{name} step: {len(ranks)} ranks vs 1 process, gradients "
              f"{grad_err}")
        step[name] = dict(logs_one_process=ref["logs"],
                          logs_ranks=got["logs"], loss_abs_err=loss_err,
                          grad_err=grad_err)
    return step


def data_axis_all_reduces(epochs: int, validation_passes: int) -> int:
    """The all-reduces of a data-axis run at the flagship recipe on phase
    6's records, as rank 0 counts them: ``DP_STEP_CALLS`` a step, 9 a
    validation batch (8 masked means, the real-row count)."""
    return (DP_STEP_CALLS["all_reduce"] * epochs * (TRAIN_ROWS // DP_BATCH)
            + 9 * validation_passes * (VAL_ROWS // DP_BATCH))


def _dp_launch(records, run, devices, backend, real, sliced=None) -> tuple:
    """``main --data_parallelism len(devices) --save_generated last`` at
    the flagship recipe for ``DP_EPOCHS`` epochs, one rank per entry of
    ``devices`` over ``backend`` through the library's launcher, after each
    rank's flagship step on its rows of ``real`` (and on the ``sliced``
    layout, where given: :func:`_dp_rank`); checked: the replicas
    equal bit for bit, equal test metrics, one writer, a shard a rank whose
    rows make the validation set, OASIS in rank 0's sampling epochs only.
    The ranks' results and the findings."""
    import glob

    import numpy as np
    from calciumgan_tpu_torch import main as train_main
    from calciumgan_tpu_torch.parallel import launch as launch_lib
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    from calciumgan_tpu_torch.utils import h5
    world = len(devices)
    config, _ = train_main.parse_args(train_flags(
        records, run, DP_EPOCHS, "--data_parallelism", str(world),
        "--save_generated", "last"))
    layout = mesh_lib.create_mesh(world, devices=devices)
    start = time.perf_counter()
    ranks = launch_lib.launch(_dp_rank, layout.devices, backend,
                              args=(config, layout, real, sliced),
                              timeout=DP_TIMEOUT_S)
    launch_s = time.perf_counter() - start
    first = ranks[0]
    check(len({r["digest"] for r in ranks}) == 1,
          f"{world} ranks: parameters, statistics or moments differ")
    check(all(np.isfinite(list(r["metrics"].values())).all()
              and r["metrics"] == first["metrics"] for r in ranks),
          f"{world} ranks: test metrics {[r['metrics'] for r in ranks]}")
    suffix = h5.default_suffix(verbose=False)
    events = sorted(os.path.relpath(p, run) for p in glob.glob(
        os.path.join(run, "**", "events.out.tfevents.*"), recursive=True))
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
    check(len(glob.glob(os.path.join(run, "hparams.json*"))) == 1
          and len(events) == 2 and ckpts == [
              f"epoch-{e:03d}.pt" for e in range(DP_EPOCHS)] + [
              "latest.json"], f"{world} ranks' writers: events {events}, "
                              f"checkpoints {ckpts}")
    last = f"epoch{DP_EPOCHS - 1:03d}_signals{suffix}"
    shards = sorted(n for n in os.listdir(os.path.join(run, "generated"))
                    if n.startswith(last))
    rows = [h5.get_shape(os.path.join(run, "generated", n), "signals")[0]
            for n in shards]
    named = [f"{last}.{r:03d}" for r in range(world)] if world > 1 \
        else [last]
    check(shards == named and sum(rows) == VAL_ROWS,
          f"{world} ranks' epoch files {shards}: {rows}")
    check(set(first["launches"]) == {"oasis_ar1/shared"}
          and first["plain_calls"] == 0
          and all(not r["launches"] and all(o is None for o in r["samples"])
                  for r in ranks[1:]),
          f"sampling launches by rank "
          f"{[(r['launches'], r['plain_calls']) for r in ranks]}")
    sampled = sampled_vs_golden([dict(out=o) for o in first["samples"]],
                                (102, T), f"{world}-rank sampling epochs")
    steps = TRAIN_ROWS // DP_BATCH
    return ranks, dict(
        devices=list(layout.devices), backend=backend, launch_s=launch_s,
        replicas_equal=True, metrics=first["metrics"], events=events,
        checkpoints=ckpts, shards=dict(zip(shards, rows)),
        collectives_rank0=first["collectives"],
        sampling_launches_rank0=first["launches"],
        sampling_launches_other_ranks=[r["launches"] for r in ranks[1:]],
        sampled_mismatches_vs_golden=sampled,
        epoch_s_rank0=first["epoch_s"],
        steps_per_s_rank0=[steps / s for s in first["epoch_s"]])


def phase_data_parallel(smi, work, records, signals, one_process,
                        beside="none"):
    """Data parallelism: (a) two ranks on ``cuda:0`` over gloo (NCCL puts
    no two ranks on one GPU) through the library's launcher: the flagship
    step at the global batch 128 against the one-process step on the same
    draws, on the data axis and on the layout of ``--dcn_slices 2
    --data_parallelism 1`` (two slices of one rank; its collectives a
    step), then ``main --data_parallelism 2 --save_generated last`` for 2
    epochs on phase 6's records (:func:`_dp_launch`'s checks; the kernel
    held to its plain version on rank 0's last sampled traces; steps/s
    beside phase 6's one-process run); (b) one rank through
    ``--distributed`` in a ``torchrun`` environment of ``WORLD_SIZE=1``
    over NCCL for 1 epoch, its collective calls counted; (c) on one GPU,
    ``--data_parallelism 2 --device cuda`` refused; on several, the same
    run over NCCL on every GPU and on one, for the steps/s of each.
    ``beside`` says what else ran on ``cuda:0`` meanwhile."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from calciumgan_tpu_torch import main as train_main
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib

    # (a) the step at the global batch, one process then two gloo ranks,
    # also on the layout the CLI makes of --dcn_slices 2
    real = np.ascontiguousarray(signals[:DP_BATCH])
    one = _flagship_steps(real, torch.device("cuda"), 0, 1, moments=True)
    dcn_config, _ = train_main.parse_args(train_flags(
        records, os.path.join(work, "dcn_run"), DP_EPOCHS, "--dcn_slices",
        str(DP_RANKS), "--data_parallelism", "1"))
    sliced = train.layout(dcn_config, ["cuda:0"] * DP_RANKS)
    check(sliced.shape[mesh_lib.DATA_AXIS] == DP_RANKS
          and sliced.slices == DP_RANKS,
          f"--dcn_slices {DP_RANKS}: layout {sliced}")
    ranks, gloo = _dp_launch(records, os.path.join(work, "dp_run"),
                             ["cuda:0"] * DP_RANKS, "gloo", real, sliced)
    gloo["step_vs_one_process"] = _step_vs_one_process(one, ranks)
    dcn_calls = {name: found["collectives_a_step"]["calls"]
                 for name, found in ranks[0]["dcn_steps"].items()}
    check(all(c == DP_STEP_CALLS for c in dcn_calls.values()),
          f"--dcn_slices {DP_RANKS} step's collectives {dcn_calls}, "
          f"expected {DP_STEP_CALLS}")
    gloo["dcn_slices_step"] = dict(
        flags=f"--dcn_slices {DP_RANKS} --data_parallelism 1",
        layout=dict(slices=sliced.slices, **sliced.shape),
        step_vs_one_process=_step_vs_one_process(one, ranks,
                                                 key="dcn_steps"),
        collectives_a_step=dcn_calls)
    last_sample = ranks[0]["samples"][-1][0]
    gloo["kernel_vs_plain"] = hold_to_twin(
        last_sample, rungs_climbed(last_sample), "2-rank sampling epoch")
    gloo["steps_per_s_one_process_phase6"] = one_process
    gloo["note"] = ("gloo through the host, two ranks on one card: a check "
                    "of the data-parallel path, no speed figure")

    # (b) one rank through --distributed over NCCL
    run_b = os.path.join(work, "dp_distributed")
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    mesh_lib.collectives.clear()
    backends = []
    train_and_validate = train.train_and_validate

    def spied(*args, **kw):
        backends.append(dist.get_backend())
        return train_and_validate(*args, **kw)

    train.train_and_validate = spied
    try:
        start = time.perf_counter()
        train_main.cli(train_flags(records, run_b, 1, "--distributed"))
        distributed_s = time.perf_counter() - start
    finally:
        train.train_and_validate = train_and_validate
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    nccl_launches = dict(oasis_cuda.launches)
    counted = dict(mesh_lib.collectives)
    # an epoch's steps and validation pass, one all-gather to join
    expected = {"all_reduce": data_axis_all_reduces(1, 1),
                "all_gather_object": 1}
    check(backends == ["nccl"] and counted == expected
          and not dist.is_initialized()
          and set(nccl_launches) == {"oasis_ar1/shared"},
          f"--distributed: backend {backends}, collectives {counted} "
          f"(expected {expected}), launches {nccl_launches}")

    # (c) two GPUs asked of one; or every GPU over NCCL
    count = torch.cuda.device_count()
    refused, gpus, scaling = None, {}, None
    if count == 1:
        try:
            train_main.cli(train_flags(records, os.path.join(
                work, "dp_refused"), 1, "--data_parallelism", "2"))
        except ValueError as exc:
            refused = str(exc)
        check(refused == "mesh needs 2 devices, have 1",
              f"--data_parallelism 2 on one GPU: {refused}")
    else:
        for world in (1, count):
            ranks_n, gpus[world] = _dp_launch(
                records, os.path.join(work, f"dp_nccl_{world}"),
                [f"cuda:{i}" for i in range(world)], "nccl", real)
            gpus[world]["step_vs_one_process"] = _step_vs_one_process(
                one, ranks_n)
        scaling = _dp_scaling(real, mesh_lib.create_mesh(
            count, devices=[f"cuda:{i}" for i in range(count)]))
    torch.cuda.synchronize()
    report("phase 14 data parallelism", card=smi, global_batch=DP_BATCH,
           epochs=DP_EPOCHS, two_ranks_gloo=gloo,
           distributed_nccl=dict(world_size=1, seconds=distributed_s,
                                 backend=backends, collectives=counted,
                                 sampling_launches=nccl_launches),
           refused_on_one_gpu=refused or f"not run: {count} GPUs",
           nccl_by_world={str(w): v for w, v in gpus.items()},
           step_loop_scaling=scaling,
           timed_beside_the_plain_versions=beside)
    return dict(launches=gloo["sampling_launches_rank0"],
                nccl_launches=nccl_launches)


# ---------------------------------------------------------------------------
# phase 15: model and time parallelism
# ---------------------------------------------------------------------------

def _layout_steps(real, dev, frames: int, m: int, precisions, **fields):
    """One flagship-width WGAN-GP step at learning rate 0 on ``frames``-
    frame sequences with phase shuffle ``m`` (the flagship configuration
    with ``fields`` over it), in each of ``precisions`` (``"f32"``: TF32
    off, ``"bf16"``), in this process's place on the layout its groups
    hold (without groups, the one-process step): its rows and frames of
    the global batch ``real``, its data index's share of ``Draws(SEED,
    0)``. The logs, the step's collective calls and bytes and, on rank 0,
    Adam's first moments (model shards gathered whole); the shard
    shapes."""
    import dataclasses

    import numpy as np
    import torch
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.algorithms.gan import Draws, shard_draws
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    di, de = mesh_lib.data_index(), mesh_lib.data_extent()
    local = torch.from_numpy(np.ascontiguousarray(mesh_lib.time_frames(
        mesh_lib.rows_of(real, di, de)))).to(dev)
    found, shards = {}, {}
    for name in precisions:
        cfg = dataclasses.replace(flagship_config(), **dict(dict(
            mixed_precision=name == "bf16", batch_size=len(real),
            learning_rate=0.0, m=m, sequence_length=frames,
            signal_shape=(frames, 102)), **fields))
        algo, shards = train.build_algorithm(cfg, dev)
        state = algo.init_state()
        mesh_lib.collectives.clear()
        mesh_lib.collective_bytes.clear()
        logs = algo.train_step(state, local, shard_draws(
            Draws(SEED, 0, dev), di, de, len(local)))
        counted = dict(calls=dict(mesh_lib.collectives),
                       bytes=dict(mesh_lib.collective_bytes))
        buffers = [b.detach().cpu().numpy()
                   for net in (state.generator, state.discriminator)
                   for b in net.module.buffers()]
        moments = {}
        for net in ("generator", "discriminator"):
            ns = getattr(state, net)
            cut = mesh_lib.sharded_parameters(ns.module)
            moments[net] = []
            for n, p in ns.module.named_parameters():
                moment = ns.optimizer.state[p]["exp_avg"]
                if n in cut:
                    moment = mesh_lib.gather_shard(moment, *cut[n])
                moments[net].append(moment.cpu().numpy())
        found[name] = dict(logs={k: float(v) for k, v in logs.items()},
                           collectives_a_step=counted,
                           moments=moments if mesh_lib.process_index() == 0
                           else None,
                           buffers_digest=hashlib.sha256(b"".join(
                               b.tobytes() for b in buffers)).hexdigest(),
                           buffers=buffers if mesh_lib.process_index() == 0
                           else None)
        del algo, state
    torch.cuda.empty_cache()
    return found, shards


def _whole_digest(state) -> str:
    """sha256 of a state's parameters, buffers and Adam moments, model
    shards gathered whole (a collective on every model peer)."""
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    digest = hashlib.sha256()
    for net in (state.generator, state.discriminator):
        cut = mesh_lib.sharded_parameters(net.module)
        for n, p in net.module.named_parameters():
            for t in (p, *(net.optimizer.state[p][k]
                           for k in ("exp_avg", "exp_avg_sq"))):
                if n in cut:
                    t = mesh_lib.gather_shard(t, *cut[n])
                digest.update(t.detach().cpu().numpy().tobytes())
        for b in net.module.buffers():
            digest.update(b.cpu().numpy().tobytes())
    return digest.hexdigest()


def mlp_batch():
    """Phase 15 (a)'s seeded batch of the mlp's data shape."""
    import numpy as np
    return np.random.default_rng(SEED + 61).random(
        (MLP_BATCH,) + MLP_FIELDS["signal_shape"]).astype(np.float32)


class cudnn_deterministic:
    """``torch.backends.cudnn.deterministic`` on and ``benchmark`` off for
    the length of a ``with``, then as they were."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        import torch
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.saved


def _par_rank(config, layout, real, frames: int, m: int):
    """One of phase 15's ranks: the step at learning rate 0
    (:func:`_layout_steps`; float32 alone on a time axis; on a model axis
    the mlp's too, ``mlp_steps``), then ``train.main`` over ``layout``
    with its sampling epochs' OASIS launches, sampled traces, epoch
    seconds, collective calls, peak device memory and the digest of its
    whole state."""
    import torch
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_lib.init_groups(layout)
    precisions = ("f32",) if layout.time_parallelism > 1 else ("f32", "bf16")
    steps, shards = _layout_steps(real, layout.device, frames, m, precisions)
    deterministic = None
    if layout.time_parallelism > 1:
        with cudnn_deterministic():
            deterministic, _ = _layout_steps(real, layout.device, frames, m,
                                             precisions)
    mlp_steps = mlp_shards = None
    if layout.model_parallelism > 1:
        mlp_steps, mlp_shards = _layout_steps(
            mlp_batch(), layout.device, MLP_FIELDS["sequence_length"], 0,
            precisions, **MLP_FIELDS)
    oasis_cuda.launches.clear()
    oasis_torch.calls = 0
    mesh_lib.collectives.clear()
    torch.cuda.reset_peak_memory_stats(layout.device)
    with Spy(train, "sample_and_plot", "train_epoch", "test") as spy:
        metrics = train.main(config, return_metrics=True, mesh=layout)
    torch.cuda.synchronize()
    return dict(rank=mesh_lib.process_index(), steps=steps, shards=shards,
                steps_cudnn_deterministic=deterministic,
                mlp_steps=mlp_steps, mlp_shards=mlp_shards, metrics=metrics,
                launches=dict(oasis_cuda.launches),
                plain_calls=oasis_torch.calls,
                collectives=dict(mesh_lib.collectives),
                peak_bytes=torch.cuda.max_memory_allocated(layout.device),
                digest=_whole_digest(spy.calls["test"][0]["args"][3]),
                samples=[c["out"] for c in spy.calls["sample_and_plot"]],
                epoch_s=[c["s"] for c in spy.calls["train_epoch"]])


def _par_launch(records, run, layout, backend, real, frames: int, m: int,
                kernel: str, rows: tuple, *flags) -> tuple:
    """``main`` with ``flags`` for ``PAR_EPOCHS`` epochs at the flagship
    recipe on ``records`` of ``rows`` (train, validation) rows of
    ``frames`` frames, one rank per device of ``layout`` over ``backend``,
    after each rank's step (:func:`_par_rank`); checked: every rank's
    whole state equal bit for bit, equal test metrics, one writer, a shard
    a data index whose rows make the validation set in whole
    ``frames``-frame rows, OASIS (``kernel``, the sampling epochs'
    machine) in rank 0's sampling epochs only. The ranks' results (rank
    0's sampled traces and spikes among them) and the findings."""
    import glob

    import numpy as np
    from calciumgan_tpu_torch import main as train_main
    from calciumgan_tpu_torch.parallel import launch as launch_lib
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    from calciumgan_tpu_torch.utils import h5
    config, _ = train_main.parse_args(train_flags(records, run, PAR_EPOCHS,
                                                  *flags))
    start = time.perf_counter()
    ranks = launch_lib.launch(_par_rank, layout.devices, backend,
                              args=(config, layout, real, frames, m),
                              timeout=PAR_TIMEOUT_S)
    launch_s = time.perf_counter() - start
    first, what = ranks[0], f"{backend} ranks of {layout.shape}"
    check(len({r["digest"] for r in ranks}) == 1,
          f"{what}: whole parameters, statistics or moments differ")
    check(all(np.isfinite(list(r["metrics"].values())).all()
              and r["metrics"] == first["metrics"] for r in ranks),
          f"{what}: test metrics {[r['metrics'] for r in ranks]}")
    events = sorted(os.path.relpath(p, run) for p in glob.glob(
        os.path.join(run, "**", "events.out.tfevents.*"), recursive=True))
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
    check(len(glob.glob(os.path.join(run, "hparams.json*"))) == 1
          and len(events) == 2 and ckpts == [
              f"epoch-{e:03d}.pt" for e in range(PAR_EPOCHS)] + [
              "latest.json"], f"{what}'s writers: events {events}, "
                              f"checkpoints {ckpts}")
    last = f"epoch{PAR_EPOCHS - 1:03d}_signals{h5.default_suffix(False)}"
    shards = sorted(n for n in os.listdir(os.path.join(run, "generated"))
                    if n.startswith(last))
    shapes = [h5.get_shape(os.path.join(run, "generated", n), "signals")
              for n in shards]
    data = mesh_lib.data_extent(layout)
    named = [f"{last}.{r:03d}" for r in range(data)] if data > 1 else [last]
    check(shards == named and sum(s[0] for s in shapes) == rows[1]
          and all(tuple(s[1:]) == (frames, 102) for s in shapes),
          f"{what}: epoch files {shards}: {shapes}")
    # a batch whose flagged share is large climbs the ladder: the deeper
    # rungs of the long one keep their rings in device memory
    check(f"{kernel}/shared" in first["launches"]
          and set(first["launches"]) <= {f"{kernel}/shared",
                                         f"{kernel}/device"}
          and first["plain_calls"] == 0
          and all(not r["launches"] and all(o is None for o in r["samples"])
                  for r in ranks[1:]),
          f"{what}: sampling launches by rank "
          f"{[(r['launches'], r['plain_calls']) for r in ranks]}")
    steps = rows[0] // int(config.batch_size)
    return ranks, dict(
        devices=list(layout.devices), backend=backend, layout=layout.shape,
        launch_s=launch_s, replicas_equal=True, metrics=first["metrics"],
        events=events, checkpoints=ckpts,
        epoch_files={n: list(s) for n, s in zip(shards, shapes)},
        shards_rank0=first["shards"], collectives_rank0=first["collectives"],
        step_collectives_rank0={name: found["collectives_a_step"]
                                for name, found in first["steps"].items()},
        peak_gb_by_rank=[r["peak_bytes"] / 2**30 for r in ranks],
        sampling_launches_rank0=first["launches"],
        epoch_s_rank0=first["epoch_s"],
        steps_per_s_rank0=[steps / s for s in first["epoch_s"]])


def long_rungs(traces) -> dict:
    """Each rung of the long ladder that the dispatch climbs on host
    ``traces`` (N, T > 4096), as on the path that deconvolved them (every
    rung takes every trace): by depth, the dispatch's production
    arguments, the launch counter's key (rings in shared memory at the
    first rung, in device memory deeper), the kernel's time by CUDA events
    on a card that runs nothing else, and its bound."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.ops import oasis_cuda
    y = torch.from_numpy(np.ascontiguousarray(traces, np.float32)).cuda()
    climbed = rungs_climbed(traces, "oasis_ar1_long_precise")
    found = {}
    for depth in dispatch._long_ladder(y.shape[-1])[:climbed]:
        prod = production(depth, precise=True)
        storage = oasis_cuda.launch_plan(depth, True).storage
        found[depth] = dict(
            prod=prod, variant=f"oasis_ar1_long_precise/{storage}",
            kernel_ms=cuda_ms(lambda: oasis_cuda.oasis_ar1_long(y, **prod),
                              reps=3), **bound(*y.shape, True))
    check(len(found) == climbed, f"long ladder: {climbed} launches on "
                                 f"{dispatch._long_ladder(y.shape[-1])}")
    return found


def _par_step_loop(dev, real, frames: int, m: int, loop=PAR_LOOP,
                   **fields) -> dict:
    """Steps/s of the recipe's step (bfloat16; ``fields`` over the
    flagship configuration) on ``frames``-frame sequences, this process's
    rows and frames of ``real`` on the layout its groups hold (none: one
    GPU), each step's draws its data index's share of ``Draws(SEED,
    step)``: one rate per timed window, and the peak device memory.
    ``loop``: steps a window, windows, untimed steps before them (phase
    15's ``PAR_LOOP``, phase 14's ``DP_SCALING``)."""
    import dataclasses

    import numpy as np
    import torch
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.algorithms.gan import Draws, shard_draws
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = dataclasses.replace(flagship_config(), batch_size=len(real), m=m,
                              sequence_length=frames,
                              signal_shape=(frames, 102), **fields)
    steps_a_window, windows, warmup = loop
    algo, _ = train.build_algorithm(cfg, dev)
    state = algo.init_state()
    di, de = mesh_lib.data_index(), mesh_lib.data_extent()
    local = torch.from_numpy(np.ascontiguousarray(mesh_lib.time_frames(
        mesh_lib.rows_of(real, di, de)))).to(dev)
    counter = 0

    def steps(n: int) -> None:
        nonlocal counter
        for _ in range(n):
            algo.train_step(state, local, shard_draws(
                Draws(SEED, counter, dev), di, de, len(local)))
            counter += 1
        torch.cuda.synchronize(dev)

    steps(warmup)
    rates = []
    for _ in range(windows):
        start = time.perf_counter()
        steps(steps_a_window)
        rates.append(steps_a_window / (time.perf_counter() - start))
    peak = torch.cuda.max_memory_allocated(dev)
    del algo, state, local
    torch.cuda.empty_cache()
    return dict(rates=rates, peak_gb=peak / 2**30)


def _nccl_rank(layout, real, frames: int, m: int, precisions, fields,
               timed: bool):
    """A rank of ``layout`` over NCCL: the step at learning rate 0 in
    ``precisions`` with ``fields`` over the flagship configuration
    (:func:`_layout_steps`), then, where ``timed``, the step loop at m 10
    (:func:`_par_step_loop`)."""
    import torch
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_lib.init_groups(layout)
    steps, shards = _layout_steps(real, layout.device, frames, m, precisions,
                                  **fields)
    loop = (_par_step_loop(layout.device, real, frames, 10, **fields)
            if timed else {})
    return dict(steps=steps, shards=shards, **loop)


def _statistics_vs_one_process(one, ranks, precisions) -> dict:
    """The running statistics (every buffer) after the ranks' step: equal
    bit for bit on every rank, and rank 0's within phase 11's bounds of
    the one-process step's, in each of ``precisions``."""
    import numpy as np
    bounds = {"f32": STEP_F32_STATS_TOL, "bf16": STEP_BF16_STATS_TOL}
    found = {}
    for name in precisions:
        digests = {r["steps"][name]["buffers_digest"] for r in ranks}
        got, ref = ranks[0]["steps"][name]["buffers"], one[name]["buffers"]
        check(len(ref) > 0 and len(got) == len(ref),
              f"{name} step: {len(got)} buffers on the ranks, {len(ref)} "
              f"in one process")
        err = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
        check(len(digests) == 1 and err <= bounds[name],
              f"{name} step's running statistics: {len(digests)} versions "
              f"over {len(ranks)} ranks, {err} from one process")
        found[name] = dict(buffers=len(ref), equal_on_every_rank=True,
                           max_abs_err_vs_one_process=err)
    return found


def _median_rates(runs) -> dict:
    import statistics
    flat = [r for run in runs for r in run]
    return dict(steps_per_s_by_launch=runs, median=statistics.median(flat),
                least=min(flat), most=max(flat))


def phase_parallel_nccl(smi, work, records, real, one, lc_real, lc_one):
    """Phase 15 (c), on four GPUs or more: data 2 x model 2 and model 4 at
    the flagship batch ``real`` (``one``: its one-process step), time 4
    and data 2 x time 2 at 16 x 16,384 frames (``lc_real``, ``lc_one``),
    over NCCL in one launch each: the step at learning rate 0 against the
    one process (the time layouts in float32), then the step loop
    (bfloat16, m 10) with every rank's peak memory, against the same loop
    on one GPU without a group; and the recipe with ``batch_norm`` at data
    2 x model 2, its step against the one process with BatchNorm and its
    running statistics equal bit for bit on every rank and within phase
    11's bounds of the one process's (not timed). One line a layout as it
    ends, with its speed-up over the one-GPU loop run before the layouts;
    then ``main
    --model_parallelism 2 --data_parallelism 2`` for 2 epochs over NCCL
    (:func:`_par_launch`'s checks, its spikes against the golden); then
    the one-GPU loop again, and the speed-ups over both one-GPU runs."""
    import torch
    from calciumgan_tpu_torch.parallel import launch as launch_lib
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    gpus = [f"cuda:{i}" for i in range(4)]
    batches = {"flagship": (real, T), "long": (lc_real, LC_T)}
    one_gpu = {key: [] for key in batches}

    def loop_one_gpu():
        for key, (batch, frames) in batches.items():
            found = _par_step_loop(torch.device("cuda:0"), batch, frames, 10)
            one_gpu[key].append(found)

    loop_one_gpu()
    both = ("f32", "bf16")
    bn = dict(batch_norm=True)
    one_bn, _ = _layout_steps(real, torch.device("cuda:0"), T, 10, both,
                              **bn)
    # name: layout, batch, m, precisions, one process, fields, timed
    layouts = {"data2_model2": (mesh_lib.create_mesh(2, 2, gpus), "flagship",
                                10, both, one, {}, True),
               "time4": (mesh_lib.create_time_mesh(1, 4, gpus), "long", 0,
                         ("f32",), lc_one, {}, True),
               "data2_time2": (mesh_lib.create_time_mesh(2, 2, gpus), "long",
                               0, ("f32",), lc_one, {}, True),
               "model4": (mesh_lib.create_mesh(1, 4, gpus), "flagship", 10,
                          both, one, {}, True),
               "data2_model2_batch_norm": (mesh_lib.create_mesh(2, 2, gpus),
                                           "flagship", 10, both, one_bn, bn,
                                           False)}
    found = {}
    for name, (layout, key, m, precisions, ref, fields,
               timed) in layouts.items():
        batch, frames = batches[key]
        ranks = launch_lib.launch(
            _nccl_rank, layout.devices, "nccl",
            args=(layout, batch, frames, m, precisions, fields, timed),
            timeout=PAR_TIMEOUT_S)
        found[name] = dict(
            layout=layout.shape, global_batch=[len(batch), frames],
            fields=fields, shards_rank0=ranks[0]["shards"],
            step_vs_one_process=_step_vs_one_process(ref, ranks, precisions))
        if name == "model4":
            check(all(r["shards"] == MP4_SHARDS for r in ranks),
                  f"model 4 shards {[r['shards'] for r in ranks]}")
        if fields.get("batch_norm"):
            found[name]["running_statistics"] = _statistics_vs_one_process(
                ref, ranks, precisions)
        if not timed:
            report(f"phase 15 nccl {name}", card=smi, **found[name])
            continue
        found[name].update(step_loop=_median_rates([ranks[0]["rates"]]),
                           peak_gb_by_rank=[r["peak_gb"] for r in ranks])
        before = _median_rates([one_gpu[key][0]["rates"]])
        report(f"phase 15 nccl {name}", card=smi, **found[name],
               one_gpu_before=dict(before, peak_gb=one_gpu[key][0]["peak_gb"]),
               speedup_over_before=found[name]["step_loop"]["median"]
               / before["median"])
    ranks, run = _par_launch(
        records, os.path.join(work, "mp_nccl"), layouts["data2_model2"][0],
        "nccl", real, T, 10, "oasis_ar1", (TRAIN_ROWS, VAL_ROWS),
        "--model_parallelism", "2", "--data_parallelism", "2",
        "--save_generated", "last")
    run["sampled_mismatches_vs_golden"] = _golden_of_samples(
        ranks[0]["samples"], (102, T), "data 2 x model 2 sampling epochs")
    report("phase 15 nccl main", card=smi, data2_model2_run=run)
    loop_one_gpu()
    for name in layouts:
        key = layouts[name][1]
        if "step_loop" not in found[name]:
            continue
        base = _median_rates([r["rates"] for r in one_gpu[key]])
        found[name]["one_gpu"] = dict(
            base, peak_gb=[r["peak_gb"] for r in one_gpu[key]])
        found[name]["speedup_of_medians"] = (
            found[name]["step_loop"]["median"] / base["median"])
    report("phase 15 nccl", card=smi, layouts=found)


def _golden_of_samples(samples, shape, what: str) -> int:
    """:func:`sampled_vs_golden` on ``train.sample_and_plot``'s results."""
    return sampled_vs_golden([dict(out=o) for o in samples], shape, what)


def _timed_golden_of_samples(samples, shape, what: str) -> tuple:
    """:func:`_golden_of_samples` and its host seconds a trace (what
    holding an evaluation of these traces to the golden would cost)."""
    start = time.perf_counter()
    mismatches = _golden_of_samples(samples, shape, what)
    return mismatches, (time.perf_counter() - start) / (
        len(samples) * shape[0])


def _long_windows(work):
    """Phase 15's seeded windows of 102 x 16,384 frames, written by the
    port's writer: their records, the global batch of the time layouts'
    step, the one-process standard step on it at m 0 (float32), and the
    seconds the writing took."""
    import numpy as np
    import torch
    start = time.perf_counter()
    records = os.path.join(work, "lc_records")
    signals = write_training_set(records, LC_TRAIN_ROWS, LC_VAL_ROWS, LC_T,
                                 seed=SEED + 15)
    write_s = time.perf_counter() - start
    real = np.ascontiguousarray(signals[:LC_BATCH])
    one, _ = _layout_steps(real, torch.device("cuda"), LC_T, 0, ("f32",))
    return records, real, one, write_s


def phase_time_parallel(work, spawn: bool = True):
    """Phase 15 (b), time parallelism on one card: ``main
    --time_parallelism 2`` in two gloo ranks on ``cuda:0`` on seeded
    windows of 102 x 16,384 frames, the step at m 0 against the
    one-process standard step at 16,384 frames (float32), 2 epochs at m 10
    (:func:`_par_launch`'s checks). The long kernel is timed at each rung
    that the dispatch climbs on rank 0's last sampled traces
    (:func:`long_rungs`); its plain version takes one to two minutes a
    rung at these frames, the float64 golden most of one, so each runs in
    a spawned process of its own while the script goes on
    (:func:`spawn_long_twins`, here unless ``spawn`` is off: the whole
    script first times phase 16 on the idle card, then holds both phases'
    launches at each rung to one plain call), and
    :func:`await_time_parallel` waits for them. Returns the findings, the
    global batch, the one-process step and what the spawned processes
    take."""
    import torch
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    start = time.perf_counter()
    records, real, one, write_s = _long_windows(work)
    layout = mesh_lib.create_time_mesh(1, TP_RANKS, ["cuda:0"] * TP_RANKS)
    ranks, tp = _par_launch(
        records, os.path.join(work, "tp_run"), layout, "gloo", real, LC_T, 0,
        "oasis_ar1_long_precise", (LC_TRAIN_ROWS, LC_VAL_ROWS),
        "--time_parallelism", str(TP_RANKS), "--batch_size", str(LC_BATCH),
        "--save_generated", "last")
    tp["step_vs_one_process_m0"] = _step_vs_one_process(
        one, ranks, ("f32",))
    # the same comparison with cuDNN held to deterministic algorithms on
    # both sides: whether the deviation is cuDNN's choice of algorithms
    with cudnn_deterministic():
        one_det, _ = _layout_steps(real, torch.device("cuda"), LC_T, 0,
                                   ("f32",))
    tp["step_vs_one_process_m0_cudnn_deterministic"] = _step_vs_one_process(
        one_det, ranks, ("f32",), key="steps_cudnn_deterministic")
    tp["write_records_s"] = write_s
    samples = ranks[0]["samples"]
    time_part = dict(findings=tp, real=real, one=one, samples=samples,
                     rungs=long_rungs(samples[-1][0]))
    tp["seconds_before_the_twin"] = time.perf_counter() - start
    if spawn:
        spawn_long_twins(time_part=time_part)
    return time_part


def await_time_parallel(time_part) -> dict:
    """:func:`phase_time_parallel`'s findings once its spawned comparisons
    have ended (waited for at the first call): the long kernel held to its
    plain version bit for bit at each rung climbed, with its time and
    bound, and the sampled spikes against the golden."""
    tp, pending = time_part["findings"], time_part.pop("pending", None)
    if pending is None:
        return tp
    waited = time.perf_counter()
    try:
        held = {d: f.result() for d, f in pending["kernel_vs_plain"].items()}
        (tp["sampled_mismatches_vs_golden"],
         tp["golden_s_per_trace"]) = pending["sampled_vs_golden"].result()
    finally:
        if pending["pool"] is not None:  # else phase 16's, shut down there
            pending["pool"].shutdown(cancel_futures=True)
    tp["kernel_vs_plain"] = {
        depth: dict(strip(held[depth]), shape=[102, LC_T], depth=depth,
                    **{k: v for k, v in rung.items()
                       if k not in ("prod", "variant")})
        for depth, rung in pending["rungs"].items()}
    tp["waited_for_the_twin_s"] = time.perf_counter() - waited
    return tp


def phase_model_time_parallel(smi, work, records, signals, time_part,
                               beside=()):
    """Model and time parallelism on one card, two gloo ranks on
    ``cuda:0`` each (NCCL puts no two ranks on one GPU), through the
    library's launcher. (a) ``main --model_parallelism 2`` at the flagship
    recipe on phase 6's records: the shards, the step at learning rate 0
    against the one-process step (float32 and bfloat16), 2 epochs
    (:func:`_par_launch`'s checks), the sampled spikes against the float64
    golden, the checkpoint whole and served by ``generate.generate``, the
    classic kernel held to its plain version on rank 0's last sampled
    traces. (b) ``time_part`` (:func:`phase_time_parallel`): its long
    kernel held to its plain version on rank 0's last sampled traces and
    their spikes against the golden, awaited here after ``beside``
    (untimed work that uses the wait). Its line, then on a machine of four
    GPUs or more :func:`phase_parallel_nccl`'s."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch import generate as generate_mod
    from calciumgan_tpu_torch.models import get_models
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    from calciumgan_tpu_torch.utils import checkpoint

    # (a) model parallelism at the flagship recipe
    start = time.perf_counter()
    real = np.ascontiguousarray(signals[:DP_BATCH])
    one, _ = _layout_steps(real, torch.device("cuda"), T, 10,
                           ("f32", "bf16"))
    mlp_one, _ = _layout_steps(mlp_batch(), torch.device("cuda"),
                               MLP_FIELDS["sequence_length"], 0,
                               ("f32", "bf16"), **MLP_FIELDS)
    mp_layout = mesh_lib.create_mesh(1, MP_RANKS, ["cuda:0"] * MP_RANKS)
    mp_run = os.path.join(work, "mp_run")
    ranks, mp = _par_launch(records, mp_run, mp_layout, "gloo", real, T, 10,
                            "oasis_ar1", (TRAIN_ROWS, VAL_ROWS),
                            "--model_parallelism", str(MP_RANKS),
                            "--save_generated", "last")
    check(all(r["shards"] == MP_SHARDS for r in ranks),
          f"model shards {[r['shards'] for r in ranks]}")
    mp["step_vs_one_process"] = _step_vs_one_process(one, ranks)
    calls = {name: found["collectives_a_step"]["calls"]
             for name, found in ranks[0]["steps"].items()}
    check(all({k: c.get(k) for k in MP_STEP_CALLS} == MP_STEP_CALLS
              for c in calls.values()),
          f"model-parallel step's collectives {calls}, expected "
          f"{MP_STEP_CALLS}")
    check(all(r["mlp_shards"] == MLP_MP_SHARDS for r in ranks),
          f"mlp model shards {[r['mlp_shards'] for r in ranks]}")
    mp["mlp"] = dict(fields=MLP_FIELDS, batch=MLP_BATCH,
                     shards_rank0=ranks[0]["mlp_shards"],
                     step_vs_one_process=_step_vs_one_process(
                         mlp_one, ranks, key="mlp_steps"),
                     collectives_a_step={
                         name: found["collectives_a_step"]
                         for name, found in ranks[0]["mlp_steps"].items()})
    mp["sampled_mismatches_vs_golden"] = _golden_of_samples(
        ranks[0]["samples"], (102, T), "model-parallel sampling epochs")
    last = ranks[0]["samples"][-1][0]
    mp["kernel_vs_plain"] = hold_to_twin(last, rungs_climbed(last),
                                         "model-parallel sampling epoch")
    ckpt_dir = os.path.join(mp_run, "checkpoints")
    stored = torch.load(checkpoint.port_checkpoint_path(
        ckpt_dir, PAR_EPOCHS - 1), map_location="cpu", weights_only=True)
    nets = dict(zip(("generator", "discriminator"), get_models(
        flagship_config(), rng=torch.Generator().manual_seed(SEED))))
    whole, expected = ({k: list(sd(k.split("/")[0])[k.split("/", 1)[1]].shape)
                        for k in MP_SHARDS} for sd in (
        lambda net: stored[net]["params"],
        lambda net: nets[net].state_dict()))
    check(whole == expected, f"model-parallel checkpoint holds {whole}, "
                             f"a one-process run {expected}")
    variables, epoch = checkpoint.restore_generator_params(ckpt_dir)
    served = next(generate_mod.generate(
        flagship_config(), variables, 4, batch_size=4, device="cuda"))
    check(served["signals"].shape == (4, T, 102)
          and bool(np.isfinite(served["signals"]).all()),
          f"served from the model-parallel checkpoint: "
          f"{served['signals'].shape}")
    mp["checkpoint"] = dict(epoch=epoch, whole_shapes=whole,
                            served=list(served["signals"].shape))
    mp["seconds"] = time.perf_counter() - start

    # (b) the time-parallel run's pending comparisons
    for task in beside:
        task()
    beside = "none" if "pending" not in time_part else (
        "(a): the plain versions of (b) (and in the whole script phase "
        "16's) ran beside it on cuda:0")
    tp = await_time_parallel(time_part)
    torch.cuda.synchronize()

    count = torch.cuda.device_count()
    report("phase 15 model and time parallelism", card=smi,
           model_parallel_gloo=mp, time_parallel_gloo=tp,
           timed_beside_the_plain_versions=beside,
           nccl=(f"not run: {count} GPU(s)" if count < 4
                 else "on four GPUs: the phase 15 nccl lines"),
           note="gloo through the host, two ranks on one card: a check of "
                "the layouts, no speed figure")
    if count >= 4:
        phase_parallel_nccl(smi, work, records, real, one,
                            time_part["real"], time_part["one"])
    return dict(mp_launches=mp["sampling_launches_rank0"],
                tp_launches=tp["sampling_launches_rank0"])


# ---------------------------------------------------------------------------
# phase 16: a long-sequence run's evaluation
# ---------------------------------------------------------------------------

def _timed_golden(traces) -> tuple:
    """:func:`golden_spikes` of host ``traces`` and its seconds a trace."""
    start = time.perf_counter()
    spikes = golden_spikes(traces)
    return spikes, (time.perf_counter() - start) / max(1, len(traces))


def _covariance_f64(spikes_nwc) -> tuple:
    """``spike_eval._per_trial_upper_cov`` of host NWC spikes in float64
    (the bin counts are integers, exact in either precision), and each
    pair's ``sigma_i sigma_j``: a :func:`stats_card_vs_cpu` reference."""
    import numpy as np
    from calciumgan_tpu_torch.ops import spike_metrics as sm
    counts = sm.bin_spike_counts(np.ascontiguousarray(
        spikes_nwc.transpose(0, 2, 1))).numpy().astype(np.float64)
    x = counts - counts.mean(-1, keepdims=True)
    cov = x @ x.transpose(0, 2, 1) / (counts.shape[-1] - 1)
    sigma = np.sqrt(np.diagonal(cov, axis1=1, axis2=2))
    upper = np.triu_indices(cov.shape[-1], 1)
    scale = sigma[:, upper[0]] * sigma[:, upper[1]]
    return cov[:, upper[0], upper[1]], np.where(scale > 0, scale, np.nan)


def _vp_of_neurons(spikes_nwc):
    """``spike_eval._per_trial_upper_vp`` of the first ``LE_VP_NEURONS``
    neurons: the CPU's DP takes seconds a trial at these frames for each
    32 neurons (it grows with the square of the neurons and of the spike
    count)."""
    from calciumgan_tpu_torch.eval import spike_eval
    return spike_eval._per_trial_upper_vp(spikes_nwc[..., :LE_VP_NEURONS])


def _statistic_costs(real, fake) -> dict:
    """Each statistic's tensor program on the card over the trials of both
    sides (NWC spikes on the card), in ``spike_eval.chunked``'s calls as
    ``compute_metrics`` makes them (128 trials a call; Victor-Purpura 16 a
    call, on ``LE_VP_TRIALS`` trials): seconds, and peak device memory in
    all and above what was held before it."""
    import torch
    from calciumgan_tpu_torch.eval import spike_eval
    found = {}
    for name, fn, n, chunk in (
            ("firing_rate", spike_eval._firing_rates_nwc, len(fake), 128),
            ("covariance", spike_eval._per_trial_upper_cov, len(fake), 128),
            ("correlation", spike_eval._per_trial_upper_corr, len(fake), 128),
            ("van_rossum", spike_eval._per_trial_upper_van_rossum, len(fake),
             128),
            ("victor_purpura", spike_eval._per_trial_upper_vp, LE_VP_TRIALS,
             16)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        start = time.perf_counter()
        for side in (real, fake):
            spike_eval.chunked(fn, side[:n], chunk)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        found[name] = dict(trials=n, seconds=time.perf_counter() - start,
                           peak_gb=peak / 2**30,
                           above_held_gb=(peak - held) / 2**30)
    return found


def phase_long_evaluation(work, train_run=None) -> dict:
    """Phase 16: a long-sequence run evaluated on the card, this part on an
    idle card. A run directory of ``LE_TRIALS`` x ``LE_T`` x
    ``LE_NEURONS`` (:func:`write_eval_run`; the generated side from
    ``train_run``'s newest checkpoint, phase 15 (b)'s time-parallel run,
    or without one seeded random weights), so that ``deconvolve_file``
    takes one full chunk of 16,320 traces in each launch. (1)
    ``compute_metrics --device cuda --covariance``: ``metrics.json``, the
    launches by rung and ring storage, the seconds by stage and statistic,
    the flag share per bit, peak memory. (2) The long kernel on the whole
    chunk at every rung of ``_long_ladder(LE_T)``: its ms by CUDA events,
    the flag share per bit (the rungs the dispatch climbed must be the
    ones the depth flags ask for) and ``LE_PLAIN_ROWS`` rows of the
    launch's outputs. (3) Each statistic's seconds and peak memory over
    every trial. Then :func:`spawn_long_twins` holds those rows bit for bit
    to the plain version in spawned processes (one a rung; one to two
    minutes a rung at these frames, so the whole script runs phases 14 and
    15 (a) meanwhile) and ``LE_GOLDEN_TRACES`` traces of the file to the
    numpy float64 golden; :func:`finish_long_evaluation` takes what this
    returns."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.eval import spike_eval
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.ops import oasis_cuda
    from calciumgan_tpu_torch.utils import h5, io
    N, C, frames = LE_TRIALS, LE_NEURONS, LE_T
    chunk = spike_eval._CHUNK_TRACES_CUDA // C
    check(chunk == N, f"{N} trials are not one chunk ({chunk}) of "
                      f"deconvolve_file")
    run = os.path.join(work, "long_eval_run")
    cfg, epoch, setup_s = write_eval_run(run, train_run, N, frames, LE_BATCH,
                                         C, on_card=True)
    filename = io.load_generated_info(cfg)[epoch]["filename"]
    check(h5.get_shape(filename, "signals") == (N, frames, C)
          and h5.get_shape(cfg.validation_cache, "spikes") == (N, frames, C),
          f"long run directory: {h5.get_shape(filename, 'signals')}")

    # 1. the main path, on an idle card
    main_run = _metrics_cli(run, "--covariance")
    launches, results = main_run["launches"], main_run["results"][epoch]
    with open(os.path.join(run, "metrics", "metrics.json")) as f:
        saved = json.load(f)
    check(list(main_run["results"]) == [epoch]
          and saved["epochs"] == {str(epoch): results}
          and sorted(results) == ["correlation_kl", "covariance_kl",
                                  "firing_rate_kl", "van_rossum_kl"]
          and saved["best_epoch"] == {k: epoch for k in results}
          and main_run["config"].num_samples == N,
          f"long run's metrics.json {saved}")
    for key, value in results.items():
        check(np.isfinite(value), f"{key} of the long run: {value}")
    ladder = dispatch._long_ladder(frames)
    storage = {d: oasis_cuda.launch_plan(d, True).storage for d in ladder}
    climbed = launched("oasis_ar1_long_precise", launches)
    expected = collections.Counter(f"oasis_ar1_long_precise/{storage[d]}"
                                   for d in ladder[:climbed])
    check(1 <= climbed <= len(ladder) and launches == dict(expected)
          and main_run["plain_calls"] == 0,
          f"long run's compute_metrics launched {launches}, plain calls "
          f"{main_run['plain_calls']}")
    stages = main_run["stages"][epoch]
    check(stages.get("deconvolve/traces") == N * C,
          f"deconvolve_file dispatched {stages.get('deconvolve/traces')}")
    flag_share = {k: stages.get(f"deconvolve/{k}", 0) / (N * C)
                  for k in ("flagged", "bit0", "bit1", "bit2")}

    # 2. the kernel on the whole chunk at every rung, the card idle
    signals = h5.get(filename, "signals")
    traces = np.ascontiguousarray(signals.transpose(0, 2, 1)).reshape(
        -1, frames)
    del signals
    y = torch.from_numpy(traces).cuda()
    rows = np.sort(np.random.default_rng(SEED).choice(
        len(traces), LE_PLAIN_ROWS, replace=False))
    at = torch.from_numpy(rows).cuda()
    rungs, launched_rows = {}, {}
    for depth in ladder:
        prod = production(depth, precise=True)
        before = collections.Counter(oasis_cuda.launches)
        c, s, redo = oasis_cuda.oasis_ar1_long(y, **prod)
        variant = list(oasis_cuda.launches - before)
        check_variant(dict(variant=variant),
                      f"oasis_ar1_long_precise/{storage[depth]}",
                      f"long kernel at the evaluation chunk, depth {depth}")
        launched_rows[depth] = [x[at].cpu().numpy() for x in (c, s, redo)]
        flags = redo.cpu().numpy()
        del c, s, redo
        rungs[depth] = dict(
            prod=prod, variant=variant[0], shape=list(y.shape),
            climbed=depth in ladder[:climbed],
            kernel_ms=cuda_ms(lambda: oasis_cuda.oasis_ar1_long(y, **prod),
                              reps=2),
            flagged_share=float((flags != 0).mean()),
            bit_share={f"bit{b}": float(((flags >> b) & 1).mean())
                       for b in range(3)},
            **bound(*y.shape, True))
    del y, at
    torch.cuda.empty_cache()
    # the dispatch climbs while more than _ESCALATE_FRAC of the traces
    # overflow their depth (bit 0), and stops at the first rung that does
    # not or at the ladder's end
    asked = next((i + 1 for i, d in enumerate(ladder) if rungs[d][
        "bit_share"]["bit0"] <= dispatch._ESCALATE_FRAC), len(ladder))
    check(asked == climbed, f"climbed {climbed} rungs, the depth flags ask "
                            f"for {asked}: {rungs}")

    # 3. each statistic over every trial, on the card still idle
    dev = torch.device("cuda")
    real = spike_eval._load_spikes(cfg, cfg.validation_cache, N, dev)
    fake = spike_eval._load_spikes(cfg, filename, N, dev)
    spikes_per_train = {side: dict(mean=float(x.sum() / (N * C)),
                                   most=int(x.sum(1).max()))
                        for side, x in (("real", real), ("fake", fake))}
    costs = _statistic_costs(real, fake)
    del real, fake
    torch.cuda.empty_cache()

    # for spawn_long_twins: each rung's rows against the plain version,
    # traces of the file against the golden
    pick = np.sort(np.random.default_rng(SEED + 1).choice(
        len(traces), LE_GOLDEN_TRACES, replace=False))
    return dict(
        cfg=cfg, filename=filename, traces=traces, pick=pick,
        jobs=dict(held={d: (f"long kernel at the evaluation chunk, depth "
                            f"{d}", traces[rows], launched_rows[d],
                            rungs[d]["variant"]) for d in ladder},
                  golden=np.array_split(traces[pick], LE_GOLDEN_WORKERS)),
        findings=dict(
            run=dict(trials=N, shape=[frames, C], traces=N * C,
                     container=os.path.splitext(filename)[1],
                     generated_by=(f"{os.path.basename(train_run)}'s epoch "
                                   f"{epoch} checkpoint" if train_run
                                   else "seeded random weights"),
                     setup_s=setup_s),
            kls_of_seeded_synthetic_data=results,
            seconds_per_epoch_file=main_run["seconds"],
            peak_gb_compute_metrics=main_run["peak_gb"], stages_s=stages,
            launches=launches, rungs_climbed=climbed, ladder=list(ladder),
            flag_share=flag_share, kernel_by_depth=rungs,
            spikes_per_train=spikes_per_train,
            statistics_all_trials=costs))


def spawn_long_twins(long_part=None, time_part=None) -> None:
    """Start phase 16's spawned comparisons (``long_part``, from
    :func:`phase_long_evaluation`) and phase 15 (b)'s (``time_part``, from
    :func:`phase_time_parallel`) in one pool: at each rung, one plain call
    on the rows of phase 16's launch and of rank 0's last sampled traces
    where phase 15 (b)'s dispatch climbed it (the same frames and
    arguments), held row for row; the goldens beside them."""
    parts = collections.defaultdict(list)
    jobs = (dict(held={}, golden=[]) if long_part is None
            else long_part.pop("jobs"))
    for d, job in jobs["held"].items():
        parts[d].append(job)
    rungs = {} if time_part is None else time_part["rungs"]
    for d, rung in rungs.items():
        check(rung["prod"] == production(d, precise=True),
              f"phase 15 (b)'s arguments at depth {d}: {rung['prod']}")
        parts[d].append((f"time-parallel sampling epoch, depth {d}",
                         time_part["samples"][-1][0], None, rung["variant"]))
    pool = _spawned_pool(len(parts) + len(jobs["golden"])
                         + (time_part is not None))
    merged = {d: pool.submit(_long_twins, production(d, precise=True), part)
              for d, part in parts.items()}
    if long_part is not None:
        long_part.update(
            pool=pool, held={d: _Share(merged[d], 0) for d in jobs["held"]},
            golden=[pool.submit(_timed_golden, part)
                    for part in jobs["golden"]])
    if time_part is not None:  # its part is the last of each rung's
        time_part["pending"] = dict(
            pool=pool if long_part is None else None, rungs=rungs,
            kernel_vs_plain={d: _Share(merged[d], len(parts[d]) - 1)
                             for d in rungs},
            sampled_vs_golden=pool.submit(
                _timed_golden_of_samples, time_part["samples"],
                (102, LC_T), "time-parallel sampling epochs"))


def finish_long_evaluation(smi, part) -> dict:
    """Phase 16 (:func:`phase_long_evaluation`) while and once its spawned
    processes end: every spike of the file against the C++ float64 kernel,
    the statistics on the card against the CPU on ``LE_CPU_TRIALS``
    trials (Victor-Purpura on ``LE_VP_TRIALS`` trials of ``LE_VP_NEURONS``
    neurons), ``deconvolve_file``'s resume (a copy of the epoch file whose
    ``_spikes_partial_c160`` holds one chunk of ones ends with the same
    spikes), then the plain version's and the golden's results. Its line;
    the kernel's findings for the ``kernels`` line."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.eval import spike_eval
    from calciumgan_tpu_torch.ops import oasis as dispatch
    from calciumgan_tpu_torch.utils import h5
    N, C, frames = LE_TRIALS, LE_NEURONS, LE_T
    cfg, filename, traces = part["cfg"], part["filename"], part["traces"]
    found = part["findings"]
    try:
        spikes = h5.get(filename, "spikes")
        check(spikes.shape == (N, frames, C) and spikes.dtype == np.int8
              and set(np.unique(spikes).tolist()) <= {0, 1},
              f"long spikes {spikes.shape} {spikes.dtype}")
        ours = np.ascontiguousarray(spikes.transpose(0, 2, 1)).reshape(
            -1, frames)
        start = time.perf_counter()
        vs_cxx = int((ours != dispatch._exact_spikes_host(
            traces, G, S_MIN, THRESHOLD)).sum())
        cxx_s = time.perf_counter() - start
        check(vs_cxx == 0,
              f"long run: {vs_cxx} spike mismatches vs the C++ float64 kernel")

        dev = torch.device("cuda")
        real = spike_eval._load_spikes(cfg, cfg.validation_cache,
                                       LE_CPU_TRIALS, dev)
        fake = spike_eval._load_spikes(cfg, filename, LE_CPU_TRIALS, dev)
        versus = stats_card_vs_cpu(real, fake, LE_CPU_TRIALS, extra=(
            ("covariance", spike_eval._per_trial_upper_cov, LE_CPU_TRIALS,
             _covariance_f64),
            ("victor_purpura", _vp_of_neurons, LE_VP_TRIALS, None)))
        del real, fake

        copy = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(filename))), "long_eval_resume",
            os.path.basename(filename))
        os.makedirs(os.path.dirname(copy))
        chunk = spike_eval._CHUNK_TRACES_CUDA // C
        staging = f"_spikes_partial_c{chunk}"
        h5.write(copy, {"signals": np.ascontiguousarray(
            traces.reshape(N, C, frames).transpose(0, 2, 1))})
        h5.write(copy, {staging: np.ones((chunk, frames, C), np.int8)})
        resume_s = spike_eval.deconvolve_file(cfg, copy, device="cuda")
        resumed = h5.get(copy, "spikes")
        check(np.array_equal(resumed, spikes)
              and not any(k.startswith("_spikes_partial")
                          for k in h5.keys(copy)),
              f"resumed spikes differ from the straight run on "
              f"{int((resumed != spikes).sum())} frames")
        h5.remove(copy)

        waited = time.perf_counter()
        plain = {d: f.result() for d, f in part["held"].items()}
        parts = [f.result() for f in part["golden"]]
        waited_s = time.perf_counter() - waited
    finally:
        part["pool"].shutdown(cancel_futures=True)
    pick = part["pick"]
    vs_golden = int((ours[pick] != np.concatenate([p[0] for p in parts]))
                    .sum())
    check(vs_golden == 0,
          f"long run: {vs_golden} spike mismatches vs the numpy golden")
    rungs = found["kernel_by_depth"]
    for d, r in rungs.items():
        r["plain"] = dict(strip(plain[d]), rows=LE_PLAIN_ROWS)
        del r["prod"]
    torch.cuda.synchronize()
    report("phase 16 long evaluation", card=smi, **found,
           spikes=dict(generated=int(spikes.sum()),
                       cxx_traces=len(traces), cxx_s=cxx_s,
                       mismatches_vs_cxx=vs_cxx, golden="oasis_ref",
                       golden_traces=LE_GOLDEN_TRACES,
                       golden_s_per_trace=[p[1] for p in parts],
                       mismatches_vs_golden=vs_golden),
           card_vs_cpu=versus,
           resume=dict(staged=staging, chunks_staged=1, seconds=resume_s),
           waited_for_the_spawned_s=waited_s)
    return dict(launches=found["launches"], shape=[N * C, frames],
                ms_by_depth={d: r["kernel_ms"] for d, r in rungs.items()},
                plain_ms_by_depth={d: r["plain"]["plain_ms"]
                                   for d, r in rungs.items()},
                plain_rows=LE_PLAIN_ROWS,
                max_abs_err=max(r["plain"]["max_abs_err"]
                                for r in rungs.values()),
                **bound(N * C, frames, True))


# ---------------------------------------------------------------------------
# phase 17: slices of the data axis on four GPUs
# ---------------------------------------------------------------------------

# phase 17's sweep: its workers, and the ranks they start, import this file
# again as ``__mp_main__`` (the spawn start method); where this variable
# names a directory, train.main there writes what each rank ran into it
RANK_SPY = "CHIP_SMOKE_RANK_SPY"


def _spy_on_ranks(directory) -> None:
    """Wrap ``train.main`` in this process: each call writes
    ``<run>.rank<r>.json`` under ``directory``: the rank's world and GPU,
    the digest of its whole state (:func:`_whole_digest`), its sampling
    epochs' OASIS launches, plain calls and collectives."""
    import functools

    import torch
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    run_main = train.main

    @functools.wraps(run_main)  # pickles as train.main, into the ranks
    def main(config, *args, **kwargs):
        oasis_cuda.launches.clear()
        oasis_torch.calls = 0
        mesh_lib.collectives.clear()
        with Spy(train, "test") as spy:
            out = run_main(config, *args, **kwargs)
        rank = mesh_lib.process_index()
        found = dict(rank=rank, world=mesh_lib.process_count(),
                     device=f"cuda:{torch.cuda.current_device()}",
                     digest=_whole_digest(spy.calls["test"][0]["args"][3]),
                     launches=dict(oasis_cuda.launches),
                     plain_calls=oasis_torch.calls,
                     collectives=dict(mesh_lib.collectives))
        name = f"{os.path.basename(config.output_dir)}.rank{rank}.json"
        with open(os.path.join(directory, name), "w") as f:
            json.dump(found, f)
        return out

    train.main = main


def _sweep_over_slices(records, work) -> dict:
    """``python -m calciumgan_tpu_torch.search --parallel 2 --device
    cuda`` in-process over ``SWEEP_GRID`` on the flagship records, batch
    64, 2 epochs: one spawned worker a slice of two GPUs, each experiment
    data-parallel over its slice over NCCL. Checked: both sessions in
    ``results.jsonl`` with finite metrics; each run's two ranks on the
    GPUs of one slice, their whole states equal bit for bit (the
    checkpoint rank 0 writes); OASIS in the first rank's sampling epochs
    only."""
    import glob

    import numpy as np
    from calciumgan_tpu_torch import search
    out = os.path.join(work, "sweep_slices")
    spied = os.path.join(work, "sweep_ranks")
    os.makedirs(spied)
    slices = search.device_slices("cuda", SWEEP_PARALLEL)
    argv = ["--input_dir", records, "--output_dir", out, "--batch_size",
            "64", "--epochs", str(SWEEP_EPOCHS), "--device", "cuda",
            "--grid", json.dumps(SWEEP_GRID), "--parallel",
            str(SWEEP_PARALLEL)]
    os.environ[RANK_SPY] = spied
    try:
        start = time.perf_counter()
        search.main(argv)
        seconds = time.perf_counter() - start
    finally:
        os.environ.pop(RANK_SPY)
    with open(os.path.join(out, "results.jsonl")) as f:
        lines = sorted((json.loads(line) for line in f),
                       key=lambda line: line["session"])
    check([line["session"] for line in lines] == [1, 2]
          and all(np.isfinite(list(line["metrics"].values())).all()
                  and "signals_metrics/mean" in line["metrics"]
                  for line in lines), f"sweep over slices: {lines}")
    runs = {}
    for line in lines:
        run = glob.glob(os.path.join(out, f"{line['session']:03d}_*"))
        check(len(run) == 1, f"session {line['session']}: runs {run}")
        name = os.path.basename(run[0])
        ranks = []
        for r in range(len(slices[0])):
            with open(os.path.join(spied, f"{name}.rank{r}.json")) as f:
                ranks.append(json.load(f))
        first = ranks[0]
        check(sorted(r["device"] for r in ranks) in slices
              and all(r["world"] == len(ranks) for r in ranks),
              f"{name}: ranks on {[r['device'] for r in ranks]}, slices "
              f"{slices}")
        check(len({r["digest"] for r in ranks}) == 1,
              f"{name}: the ranks' whole states differ")
        check(set(first["launches"]) == {"oasis_ar1/shared"}
              and all(not r["launches"] and not r["plain_calls"]
                      for r in ranks[1:]) and first["plain_calls"] == 0,
              f"{name}: sampling launches by rank "
              f"{[(r['launches'], r['plain_calls']) for r in ranks]}")
        ckpts = sorted(os.listdir(os.path.join(run[0], "checkpoints")))
        runs[line["session"]] = dict(
            params={k: line["params"][k] for k in SWEEP_GRID},
            metrics=line["metrics"], seconds=line["elapse"],
            devices=[r["device"] for r in ranks], replicas_equal=True,
            checkpoints=ckpts, sampling_launches_rank0=first["launches"],
            collectives_rank0=first["collectives"])
    return dict(slices=slices, seconds=seconds,
                seconds_per_experiment=[r["seconds"] for r in runs.values()],
                experiments=runs)


def phase_slices(smi, work, records, signals):
    """Phase 17, on four GPUs: (a) ``main --dcn_slices 2
    --data_parallelism 2`` at the flagship recipe for 2 epochs over NCCL
    (:func:`_par_launch`'s checks: every replica equal bit for bit, one
    writer, a shard a data index, OASIS in rank 0's sampling epochs only),
    each rank's step at learning rate 0 against the one-process step
    within phase 14's bounds, its collectives those of the data axis
    (``DP_STEP_CALLS``), the sampled spikes against the golden; the step
    loop on the sliced layout against one GPU, in the order 1, 4, 4, 1;
    (b) the sweep over two-GPU slices (:func:`_sweep_over_slices`)."""
    import numpy as np
    import torch
    from calciumgan_tpu_torch.parallel import mesh as mesh_lib
    gpus = [f"cuda:{i}" for i in range(torch.cuda.device_count())][:4]
    check(len(gpus) == 4, f"phase 17 needs four GPUs, have {len(gpus)}")
    real = np.ascontiguousarray(signals[:DP_BATCH])
    one, _ = _layout_steps(real, torch.device("cuda:0"), T, 10,
                           ("f32", "bf16"))
    layout = mesh_lib.create_mesh(DCN_DATA, devices=gpus, slices=DCN_SLICES)
    ranks, run = _par_launch(
        records, os.path.join(work, "dcn_nccl"), layout, "nccl", real, T, 10,
        "oasis_ar1", (TRAIN_ROWS, VAL_ROWS), "--dcn_slices", str(DCN_SLICES),
        "--data_parallelism", str(DCN_DATA), "--save_generated", "last")
    run["step_vs_one_process"] = _step_vs_one_process(one, ranks)
    calls = run["step_collectives_rank0"]
    check(all(c["calls"] == DP_STEP_CALLS for c in calls.values()),
          f"--dcn_slices step's collectives {calls}, expected "
          f"{DP_STEP_CALLS} (data {len(gpus)})")
    # the run's: its epochs' steps and validation passes, and the test's
    expected = {"all_reduce": data_axis_all_reduces(PAR_EPOCHS,
                                                    PAR_EPOCHS + 1)}
    check(run["collectives_rank0"] == expected,
          f"--dcn_slices run's collectives {run['collectives_rank0']}, "
          f"expected {expected}")
    run["sampled_mismatches_vs_golden"] = _golden_of_samples(
        ranks[0]["samples"], (102, T), "sliced run's sampling epochs")
    run["step_loop_scaling"] = _dp_scaling(real, layout, PAR_LOOP)
    report("phase 17 dcn slices", card=smi,
           flags=f"--dcn_slices {DCN_SLICES} --data_parallelism {DCN_DATA}",
           global_batch=DP_BATCH, epochs=PAR_EPOCHS, dcn_run=run)
    report("phase 17 sweep over slices", card=smi, grid=SWEEP_GRID,
           batch_size=64, epochs=SWEEP_EPOCHS, parallel=SWEEP_PARALLEL,
           **_sweep_over_slices(records, work))


def main(argv) -> int:
    import numpy as np
    import torch
    if argv not in ([], ["--phase", "14"], ["--phase", "15"],
                    ["--phase", "15-nccl"], ["--phase", "16"],
                    ["--phase", "17"]):
        print("usage: chip_smoke.py [--phase 14|15|15-nccl|16|17]",
              file=sys.stderr)
        return 2
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
    if argv == ["--phase", "16"]:  # generated by seeded random weights
        with tempfile.TemporaryDirectory() as work:
            long_part = phase_long_evaluation(work)
            spawn_long_twins(long_part)
            finish_long_evaluation(smi, long_part)
        print(smi)
        return ok_line()
    if argv:  # phase 14, 15 or 17 alone, on a training set of its own
        with tempfile.TemporaryDirectory() as work:
            records = os.path.join(work, "records")
            signals = write_training_set(records)
            if argv[1] == "14":
                phase_data_parallel(smi, work, records, signals, None)
            elif argv[1] == "15-nccl":
                check(torch.cuda.device_count() >= 4,
                      f"--phase 15-nccl needs four GPUs, have "
                      f"{torch.cuda.device_count()}")
                real = np.ascontiguousarray(signals[:DP_BATCH])
                one, _ = _layout_steps(real, torch.device("cuda"), T, 10,
                                       ("f32", "bf16"))
                _, lc_real, lc_one, _ = _long_windows(work)
                phase_parallel_nccl(smi, work, records, real, one, lc_real,
                                    lc_one)
            elif argv[1] == "17":
                phase_slices(smi, work, records, signals)
            else:
                phase_model_time_parallel(smi, work, records, signals,
                                          phase_time_parallel(work))
            flush_twins()
        print(smi)
        return ok_line()
    # the timed parts of phases 3-5 on an idle card; phases 2 and 3's
    # untimed work, and phase 10's step on the card against the CPU (it
    # times nothing and needs no earlier phase), beside phase 5's spawned
    # comparisons
    config = flagship_config()
    weights, _ = get_models(config, rng=torch.Generator().manual_seed(SEED))
    variables = convert.flax_generator_variables(weights.state_dict())
    serving_launches, slice_checks = phase_slice(config, variables)
    serving = phase_timings(config, variables, smi)
    early = {}

    def step2d():
        start = time.perf_counter()
        early["step2d"] = dict(step2d_card_vs_cpu(),
                               seconds=time.perf_counter() - start)

    recordings = phase_recordings(
        smi, beside=(phase_kernel, slice_checks, step2d))
    with tempfile.TemporaryDirectory() as work:
        training = phase_training(smi, work)
        recording = recordings.pop("recording")
        phase_prepare(smi, work, recording)
        evaluation = phase_evaluation(smi, work, training["run"])
        dg = phase_dg(smi, work, recording)
        conv2d = phase_conv2d(smi, work, recording, early["step2d"])
        batch_norm = phase_batch_norm(smi, work, training["records"],
                                      training["head"])
        in_graph = phase_in_graph(smi, config, variables)
        sweep = phase_sweep(smi, work, training["records"])
        # phase 15's time-parallel run first, then phase 16 on its
        # checkpoint while the card is idle: on one GPU both phases' long
        # plain versions run beside phase 14 and phase 15's model-parallel
        # run (no speed figure there); on several, they end before phase
        # 14's step loops are timed
        time_part = phase_time_parallel(work, spawn=False)
        long_part = phase_long_evaluation(work, os.path.join(work, "tp_run"))
        spawn_long_twins(long_part, time_part)
        beside = "phase 15 (b)'s and phase 16's plain versions, on cuda:0"
        long_eval = None
        if torch.cuda.device_count() > 1:
            await_time_parallel(time_part)
            long_eval = finish_long_evaluation(smi, long_part)
            beside = "none"
        parallel = phase_data_parallel(
            smi, work, training["records"], training["head_128"],
            training["timing"]["steps_per_s_host"], beside)
        # the deferred plain calls while phase 15 waits for (b)'s
        twins = {}
        model_time = phase_model_time_parallel(
            smi, work, training["records"], training["head_128"], time_part,
            beside=(lambda: twins.update(err=flush_twins()),))
        if long_eval is None:
            long_eval = finish_long_evaluation(smi, long_part)
    twins_err = twins["err"]
    jax_loaded = [m for m in ("jax", "flax", "optax") if m in sys.modules]
    check(not jax_loaded, f"imported {jax_loaded}")

    print(smi)
    source = "calciumgan_tpu_torch/csrc/oasis_ar1.cu"
    long_counts = (collections.Counter(recordings["long_counts"])
                   + collections.Counter(model_time["tp_launches"])
                   + collections.Counter(long_eval["launches"]))
    # no single PyTorch call computes OASIS: library_ms is null
    print(json.dumps({"kernels": [
        {"name": "oasis_ar1", "route": "cuda", "source": source,
         "replaces": "calciumgan_tpu/ops/oasis_pallas.py:603",
         **path_launches("oasis_ar1", collections.Counter(serving_launches)
                         + collections.Counter(training["launches"])
                         + collections.Counter(evaluation["launches"])
                         + collections.Counter(dg["train_launches"])
                         + collections.Counter(dg["metrics_launches"])
                         + collections.Counter(dg["mlp_launches"])
                         + collections.Counter(conv2d["train_launches"])
                         + collections.Counter(conv2d["metrics_launches"])
                         + collections.Counter(conv2d["serve_launches"])
                         + collections.Counter(
                             batch_norm["train_launches"])
                         + collections.Counter(in_graph["launches"])
                         + collections.Counter(sweep["launches"])
                         + collections.Counter(parallel["launches"])
                         + collections.Counter(parallel["nccl_launches"])
                         + collections.Counter(model_time["mp_launches"])),
         "launches_by_path": {
             "generate --spikes": launched("oasis_ar1", serving_launches),
             "main (sampling epochs)": launched("oasis_ar1",
                                                training["launches"]),
             "compute_metrics": launched("oasis_ar1",
                                         evaluation["launches"]),
             "main --ema --device_store off on DG records (sampling "
             "epochs)": launched("oasis_ar1", dg["train_launches"]),
             "compute_dg_metrics": launched("oasis_ar1",
                                            dg["metrics_launches"]),
             "main --model mlp --algorithm gan (sampling epochs)": launched(
                 "oasis_ar1", dg["mlp_launches"]),
             "main --model calciumgan2d (sampling epochs)": launched(
                 "oasis_ar1", conv2d["train_launches"]),
             "compute_metrics on the conv2d run": launched(
                 "oasis_ar1", conv2d["metrics_launches"]),
             "generate --spikes from the conv2d run": launched(
                 "oasis_ar1", conv2d["serve_launches"]),
             "main --batch_norm --algorithm gan --ema (sampling epochs)":
                 launched("oasis_ar1", batch_norm["train_launches"]),
             "deconvolve_signals (in-graph)": launched(
                 "oasis_ar1", in_graph["launches"]),
             "search (sampling epochs)": launched("oasis_ar1",
                                                  sweep["launches"]),
             "main --data_parallelism 2 (rank 0 sampling epochs)": launched(
                 "oasis_ar1", parallel["launches"]),
             "main --distributed (sampling epochs)": launched(
                 "oasis_ar1", parallel["nccl_launches"]),
             "main --model_parallelism 2 (rank 0 sampling epochs)": launched(
                 "oasis_ar1", model_time["mp_launches"])},
         "path": "generate --spikes; main (sampling epochs); "
                 "compute_metrics (one epoch file of 1000 x 2048 x 102); "
                 "the DG run's and the mlp run's sampling epochs; "
                 "compute_dg_metrics (one epoch file of 64 x 2048 x 100); "
                 "the conv2d run's sampling epochs, compute_metrics (64 x "
                 "2048 x 102) and generate --spikes; the BatchNorm run's "
                 "sampling epochs; deconvolve_signals (in-graph, 104,448 x "
                 "2048 at depth 128, merge budget 4); search (the two "
                 "experiments' sampling epochs); main --data_parallelism 2 "
                 "(rank 0's sampling epochs), main --distributed and main "
                 "--model_parallelism 2 (rank 0's sampling epochs)",
         "library_ms": None,
         **dict(serving, max_abs_err=max(twins_err, serving["max_abs_err"],
                                         in_graph["max_abs_err"]))},
        {"name": "oasis_ar1_precise", "route": "cuda", "source": source,
         "replaces": "calciumgan_tpu/ops/oasis_pallas.py:603",
         "library_ms": None, **recordings["precise"]},
        {"name": "oasis_ar1_long", "route": "cuda", "source": source,
         "replaces": "calciumgan_tpu/ops/oasis_pallas.py:513",
         "library_ms": None, **dict(
             recordings["long"],
             path="spike_train_inference --device cuda; main "
                  "--time_parallelism 2 (rank 0's sampling epochs, 102 x "
                  f"{LC_T}); compute_metrics on a long run (one chunk of "
                  f"{LE_TRIALS * LE_NEURONS} x {LE_T})",
             **path_launches("oasis_ar1_long_precise", long_counts),
             launches_by_path={
                 "spike_train_inference --device cuda": launched(
                     "oasis_ar1_long_precise", recordings["long_counts"]),
                 "main --time_parallelism 2 (rank 0 sampling epochs)":
                     launched("oasis_ar1_long_precise",
                              model_time["tp_launches"]),
                 "compute_metrics on a long run": launched(
                     "oasis_ar1_long_precise", long_eval["launches"])},
             evaluation_chunk=dict(
                 long_eval,
                 launches=path_launches("oasis_ar1_long_precise",
                                        long_eval["launches"])))}]}))
    return ok_line()


def ok_line() -> int:
    """The last line: the device's platform, kind and count."""
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__mp_main__" and os.environ.get(RANK_SPY):
    _spy_on_ranks(os.environ[RANK_SPY])

if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
