"""Training loop (counterpart of ``calciumgan_tpu/train.py``): epoch loop,
validation, sampling with spike deconvolution, checkpointing.

The epoch structure is the JAX package's (reference ``main.py:22-224``):
train pass, validation pass, sample + plot + checkpoint every
``--checkpoint_every`` epochs and at the last one, a profiler window at
epoch 1 batches 2-6, per-epoch elapse scalars, and optional surrogate-set
generation. The batches are the JAX package's too: each epoch shuffles with
``np.random.default_rng(seed + epoch)`` and drops the remainder; validation
pads its tail batch by repeating the last real row and masks the filler.

Randomness: a step's :class:`~calciumgan_tpu_torch.algorithms.gan.Draws` is
seeded from ``(seed, global_step)``, so a resumed run replays the same
draws (``train.py:123``); validation from ``(seed, 10**9 + epoch * steps +
i)`` (``:191``). Eager PyTorch; steps return their logs as device
tensors, which are read once per epoch.

Data parallelism (``train.py:65-73,90-135,165-235,249-300,309-360``): a
run of P data ranks (:func:`run` starts them, or ``--distributed`` joins
them) gives each its share of the records and a local batch of
``batch_size / P`` rows. Steps per epoch come from the GLOBAL sizes
(:func:`_epoch_steps`), so every rank makes the same collectives; the
draws are the global batch's, each rank keeping its rows
(:class:`~calciumgan_tpu_torch.algorithms.gan.ShardDraws`); validation
pads and masks each rank's tail and weights its means globally. Rank 0
alone deconvolves and plots, and writes the checkpoints, ``hparams.json``,
the events and ``info.pkl``; each data index writes its shard of the epoch
files and of the surrogate set.

Model and time parallelism (``--model_parallelism``, ``--time_parallelism``,
``train.py:408-442``): each data index has M model or T time peers, which
read the same records and draw the same rows (the data index and extent,
:mod:`~calciumgan_tpu_torch.parallel.mesh`). A model peer holds its shards
of the two sequence-sized Dense layers (``mesh.shard_models``); a time
peer holds its frames of every batch and trains
:class:`~calciumgan_tpu_torch.parallel.long_context.LongContextWGAN_GP`.
The peers of data index 0 all run the sampling epochs' generator pass
(the time peers' frames gathered into whole sequences), and the first of
each data index's peers writes its shard of the generated signals, whole
sequences too.

Not ported: the persistent compile cache and the backend probe.

``--save_generated`` keeps the validation pass's generated batches under the
JAX package's policy (``calciumgan_tpu/train.py:165-209``): ``all`` on every
``--checkpoint_every``-th and on the last epoch, ``last`` on the last epoch
only. Each batch is copied to the host and written as it comes
(:func:`calciumgan_tpu_torch.utils.io.save_fake_signals`), so the copy and
the write belong to the validation pass's ``elapse``; their own seconds are
the validation scalar ``elapse/save_generated``.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
from shutil import rmtree
from time import perf_counter, time
from typing import Dict, Optional

import numpy as np
import torch

from calciumgan_tpu_torch.algorithms import get_algorithm
from calciumgan_tpu_torch.algorithms.gan import Draws, shard_draws
from calciumgan_tpu_torch.data import pipeline
from calciumgan_tpu_torch.eval.spike_eval import deconvolve_traces
from calciumgan_tpu_torch.models import get_models
from calciumgan_tpu_torch.parallel import launch as launch_lib
from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import arrays, checkpoint, io, tracing
from calciumgan_tpu_torch.utils.device import resolve_device
from calciumgan_tpu_torch.utils.summary import Summary

# draw counters outside the train steps' global_step range
_VALIDATION_COUNTER = 10**9
_TEST_NOISE_COUNTER = 2**31 - 1


def _progress(iterable, desc, total, verbose):
    if not verbose:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, total=total)


def count_params(module: torch.nn.Module) -> int:
    """The parameters of the whole net, model shards counted whole (as the
    JAX package counts its global arrays, ``train.py:456-473``)."""
    return sum(int(np.prod(s)) for s in mesh_lib.whole_shapes(module).values())


def layer_table(module: torch.nn.Module) -> str:
    """The ``--verbose 2`` table of a net (the JAX package prints Flax's
    ``tabulate``, ``train.py:460-469``): one row per module that holds
    parameters or buffers of its own, with its class, parameter count and
    their whole shapes (buffers, the BatchNorm running statistics, marked
    and not counted), then the total."""
    whole = mesh_lib.whole_shapes(module)
    rows = [f"{type(module).__name__}"]
    for name, sub in module.named_modules():
        params = {k: whole[f"{name}.{k}" if name else k]
                  for k, _ in sub.named_parameters(recurse=False)}
        buffers = dict(sub.named_buffers(recurse=False))
        if not params and not buffers:
            continue
        shapes = [f"{k} {v}" for k, v in params.items()]
        shapes += [f"{k} {tuple(v.shape)} (buffer)"
                   for k, v in buffers.items()]
        count = sum(int(np.prod(s)) for s in params.values())
        rows.append(f"  {name:<24} {type(sub).__name__:<14} {count:>12,}  "
                    + ", ".join(shapes))
    rows.append(f"  {'total':<24} {'':<14} {count_params(module):>12,}")
    return "\n".join(rows)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean_logs(all_logs, weights=None) -> Dict[str, float]:
    """Average per-batch log dicts of device tensors, optionally weighted by
    real rows, with one copy to the host."""
    if not all_logs:
        return {}
    keys = list(all_logs[0])
    table = torch.stack([torch.stack([logs[k].float() for k in keys])
                         for logs in all_logs]).double().cpu().numpy()
    w = None if weights is None else torch.stack(
        [x.float() for x in weights]).double().cpu().numpy()
    return {k: float(np.average(table[:, j], weights=w))
            for j, k in enumerate(keys)}


def _epoch_steps(global_size: int, local_bs: int,
                 drop_remainder: bool) -> int:
    """Steps per epoch, the same on every rank: from the least number of
    rows a data index holds (record ``i`` goes to data index ``i % P``, so
    each holds ``floor(global / P)`` or one more), ``train.py:65-73``."""
    min_local = global_size // mesh_lib.data_extent()
    if drop_remainder:
        return min_local // local_bs
    return -(-min_local // local_bs)


def _draws(config, counter: int, device: torch.device, batch: int,
           seed=None):
    """The draws of one step (or evaluation batch): this rank's rows of the
    global draws from ``(seed, counter)``, ``batch`` local rows (its data
    index's: model and time peers draw alike)."""
    seed = config.seed if seed is None else seed
    return shard_draws(Draws(seed, counter, device), mesh_lib.data_index(),
                       mesh_lib.data_extent(), batch)


def focus_neurons(config):
    """The reference's 9 plotted neurons, clamped to the dataset's neuron
    count (``train.py:76-82``)."""
    idx = [i for i in config.focus_neurons if i < config.num_neurons]
    return idx or list(range(min(9, config.num_neurons)))


class _ProfileWindow:
    """``torch.profiler`` over a few steps: writes the Chrome trace, and to
    ``window.json`` the window's host seconds, device-busy seconds (union
    of the intervals of the device's work, spans left out), busy share, the
    kernels that took the most device time and the device seconds under
    each of the program's spans (:mod:`~calciumgan_tpu_torch.utils.
    tracing`)."""

    def __init__(self, profiler_dir: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.dir, self.device = profiler_dir, device
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        _synchronize(device)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._start = perf_counter()
        self.steps = 0

    def stop(self) -> dict:
        _synchronize(self.device)
        wall = perf_counter() - self._start
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        events = list(self._prof.events())
        kernels = tracing.device_work(events)
        busy = tracing.busy_seconds(kernels) if kernels else None
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in kernels:
            by_name[e.name][0] += e.time_range.end - e.time_range.start
            by_name[e.name][1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        window = {"steps": self.steps, "wall_s": wall,
                  "device_busy_s": busy,
                  "device_busy_share": None if busy is None else busy / wall,
                  "device_events": len(kernels),
                  "top_kernels": [{"name": n[:100], "ms": us * 1e-3,
                                   "count": c}
                                  for n, (us, c) in top],
                  "span_device_s": tracing.span_device_seconds(events)}
        with open(os.path.join(self.dir, "window.json"), "w") as f:
            json.dump(window, f)
        return window


# ---------------------------------------------------------------------------
# epoch passes
# ---------------------------------------------------------------------------

def epoch_batches(config, epoch: int, rows: Optional[int] = None,
                  steps: Optional[int] = None) -> list:
    """The row indices of each of ``epoch``'s training batches of
    ``local_batch_size`` rows: the JAX training loop's shuffle
    (``np.random.default_rng(seed + epoch)`` over the ``rows`` this rank
    holds, default ``train_size``, ``train.py:94-107``), ``steps`` of them
    (default: the remainder dropped)."""
    rows = config.train_size if rows is None else rows
    bs = mesh_lib.local_batch_size(config.batch_size)
    steps = rows // bs if steps is None else steps
    order = np.arange(rows)
    np.random.default_rng(config.seed + epoch).shuffle(order)
    return [order[i * bs:(i + 1) * bs] for i in range(steps)]


def train_epoch(config, source, algo, state, summary: Summary, epoch: int,
                device: torch.device) -> Dict[str, float]:
    """One pass over the training set (reference ``main.py:33-75``). A
    :class:`~calciumgan_tpu_torch.data.pipeline.HostBatches` source streams
    its batches through a
    :class:`~calciumgan_tpu_torch.data.pipeline.DevicePrefetcher`, as the
    JAX training epoch does (``train.py:108-113``); the same batches in
    the same order."""
    local_bs = mesh_lib.local_batch_size(config.batch_size)
    batches = epoch_batches(config, epoch, len(source), _epoch_steps(
        config.train_size, local_bs, drop_remainder=True))
    reals = (pipeline.DevicePrefetcher(source, batches)
             if isinstance(source, pipeline.HostBatches)
             else map(source.batch, batches))
    all_logs = []
    window = None
    start = time()
    for batch_count, real in enumerate(_progress(reals, "Train",
                                                 len(batches),
                                                 config.verbose)):
        if (config.profile and epoch == 1 and batch_count == 2
                and summary.profiler_dir is not None):
            window = _ProfileWindow(summary.profiler_dir, device)
        draws = _draws(config, config.global_step, device, local_bs)
        all_logs.append(algo.train_step(state, real, draws))
        config.global_step += 1
        if window is not None:
            window.steps += 1
            if batch_count == 6:
                window.stop()
                window = None
    if window is not None:  # the window reaches past a short epoch
        window.stop()
    _synchronize(device)
    elapse = time() - start

    logs = _mean_logs(all_logs)
    summary.log(logs, elapse=elapse, weights=plotted_weights(config, state),
                step=epoch, training=True)
    return logs


def plotted_weights(config, state) -> Optional[Dict[str, dict]]:
    """Both nets' whole parameters for ``--plot_weights``, else None. Every
    rank calls it: a model shard is gathered over its model group, which
    every peer joins, writer or not (rank 0 alone writes them)."""
    if not config.plot_weights:
        return None
    return {net: mesh_lib.whole_parameters(getattr(state, net).module)
            for net in ("generator", "discriminator")}


def _validation_batches(source, n: int, bs: int, steps: int):
    """(batch, real row count) pairs of one validation pass; the tail batch
    pads by repeating the last real row."""
    for i in range(steps):
        idx, real_count = mesh_lib.pad_to_multiple(
            np.arange(i * bs, min(n, (i + 1) * bs)), bs)
        yield source.batch(idx), real_count


def _row_mask(bs: int, real_count: int, device) -> torch.Tensor:
    mask = torch.zeros(bs, dtype=torch.float32)
    mask[:real_count] = 1.0
    return mask.to(device)


def saves_generated(config, epoch: int) -> bool:
    """Whether ``epoch``'s validation pass keeps its generated signals: the
    cadence of sampling and checkpointing (``--checkpoint_every``; the
    reference hard-codes 10 for both, ``main.py:103,141``)."""
    every = max(1, config.checkpoint_every)
    last = epoch == config.epochs - 1
    return ((config.save_generated == "all" and (epoch % every == 0 or last))
            or (config.save_generated == "last" and last))


def validate_epoch(config, source, algo, state, summary: Summary, epoch: int,
                   device: torch.device) -> Dict[str, float]:
    """One validation pass (reference ``main.py:78-122``), means weighted
    by real rows (every rank's: the step's masked means and its real-row
    count are global); saves the generated signals per
    ``--save_generated``, each rank its own rows."""
    bs = mesh_lib.local_batch_size(config.batch_size)
    steps = _epoch_steps(config.validation_size, bs, drop_remainder=False)
    save_generated = saves_generated(config, epoch)
    all_logs, weights = [], []
    save_s = 0.0
    start = time()
    batches = _validation_batches(source, len(source), bs, steps)
    for i, (real, real_count) in enumerate(
            _progress(batches, "Validate", steps, config.verbose)):
        draws = _draws(config, _VALIDATION_COUNTER + epoch * steps + i,
                       device, bs)
        fake, logs = algo.eval_step(state, real, draws,
                                    _row_mask(bs, real_count, device))
        weights.append(logs.pop("batch/real_rows"))
        all_logs.append(logs)
        if save_generated:
            # the first batch replaces any file left by a run of the same
            # epoch that was killed (writes append); the filler rows of the
            # tail batch are dropped
            _synchronize(device)
            saving = perf_counter()
            io.save_fake_signals(config, epoch,
                                 mesh_lib.gather_time(fake[:real_count]),
                                 append=i > 0)
            save_s += perf_counter() - saving
    _synchronize(device)
    elapse = time() - start

    logs = _mean_logs(all_logs, weights=weights)
    if save_generated:
        summary.scalar("elapse/save_generated", save_s, step=epoch,
                       training=False)
    summary.log(logs, elapse=elapse, step=epoch, training=False)
    return logs


def _traces(config, signals: torch.Tensor) -> torch.Tensor:
    """One sample's ``(time, neuron)`` signals as ``(neuron, time)``."""
    if tuple(signals.shape) != (config.sequence_length, config.num_neurons):
        raise ValueError(f"sample of shape {tuple(signals.shape)}, expected "
                         f"({config.sequence_length}, {config.num_neurons})")
    return signals.transpose(0, 1).contiguous()


def sample_and_plot(config, algo, state, summary: Summary, epoch: int,
                    test_noise: torch.Tensor):
    """Generate from the fixed test noise, deconvolve its traces where they
    lie (the OASIS kernel on the card) and plot them (reference
    ``main.py:141-156``). Returns the ``(neuron, time)`` signals and
    spikes as host arrays; None off rank 0, which alone deconvolves and
    plots. The generator pass is data index 0's: its model or time peers
    join it (their collectives), the time peers' frames gathered into the
    whole sequence; no other rank calls a collective here."""
    if mesh_lib.data_index() != 0:
        return None
    fake = mesh_lib.gather_time(algo.sample(state, test_noise))
    if mesh_lib.process_index() != 0:
        return None
    fake = pipeline.reverse_preprocessing(config, fake)
    signals = _traces(config, fake[0])
    spikes = deconvolve_traces(signals).astype(np.float32)
    signals = signals.cpu().numpy()
    summary.plot_traces("fake_traces", signals, spikes,
                        indexes=focus_neurons(config), step=epoch,
                        training=False)
    return signals, spikes


def plot_real_signals(config, summary: Summary, dataset) -> None:
    """First validation batch's traces at step 0
    (reference ``dataset_helper.py:33-51``); rank 0's."""
    if mesh_lib.process_index() != 0:
        return
    signal, spike = next(dataset.batches(config.batch_size))
    signal = pipeline.reverse_preprocessing(
        config, torch.from_numpy(np.ascontiguousarray(signal)))
    # the surrogate pickle stores its spikes (neuron, time) already: the
    # layout is read off the shape, as the JAX package does
    summary.plot_traces("real_traces", _traces(config, signal[0]).numpy(),
                        arrays.set_array_format(np.asarray(spike[0]), "CW",
                                                config),
                        indexes=focus_neurons(config), step=0, training=False)


def make_batch_sources(config, train_ds, validation_ds,
                       device: torch.device):
    """The train and validation signals on the device (``--device_store``)
    or streamed per batch from the host; a time rank's frames of them."""
    train, validation = (mesh_lib.time_frames(ds.signals)
                         for ds in (train_ds, validation_ds))
    total = train.nbytes + validation.nbytes
    if pipeline.device_store_enabled(config, total, device):
        if config.verbose:
            print(f"device store: {total / 2**20:.0f} MB of signals on "
                  f"{device} (batches gather there)")
        return (pipeline.DeviceStore(train, device),
                pipeline.DeviceStore(validation, device))
    return (pipeline.HostBatches(train, device),
            pipeline.HostBatches(validation, device))


def train_and_validate(config, train_ds, validation_ds, algo, state,
                       summary: Summary, device: torch.device):
    """Epoch loop (reference ``main.py:125-165``). Returns the validation
    batch source."""
    train_src, val_src = make_batch_sources(config, train_ds, validation_ds,
                                            device)
    test_noise = Draws(config.seed, _TEST_NOISE_COUNTER, device).noise(
        1, config.noise_dim)

    for epoch in range(config.start_epoch, config.epochs):
        if config.verbose:
            print(f"Epoch {epoch:03d}/{config.epochs:03d}")
        start = time()
        train_logs = train_epoch(config, train_src, algo, state, summary,
                                 epoch, device)
        val_logs = validate_epoch(config, val_src, algo, state, summary,
                                  epoch, device)

        every = max(1, config.checkpoint_every)
        if epoch % every == 0 or epoch == config.epochs - 1:
            sample_and_plot(config, algo, state, summary, epoch, test_noise)
            if not config.skip_checkpoints:
                checkpoint.save(config.ckpt_dir, epoch, state, config=config,
                                verbose=config.verbose)

        if config.verbose:
            print("Train: generator loss {:.04f} discriminator loss {:.04f}\n"
                  "Eval: generator loss {:.04f} discriminator loss {:.04f}\n"
                  "Elapse: {:.02f} mins\n".format(
                      train_logs.get("loss/generator", float("nan")),
                      train_logs.get("loss/discriminator", float("nan")),
                      val_logs.get("loss/generator", float("nan")),
                      val_logs.get("loss/discriminator", float("nan")),
                      (time() - start) / 60))
    return val_src


def test(config, validation_ds, algo, state, device: torch.device,
         source=None) -> Dict[str, float]:
    """Final metrics over the validation set (reference
    ``main.py:168-181``)."""
    source = source or pipeline.HostBatches(
        mesh_lib.time_frames(validation_ds.signals), device)
    bs = mesh_lib.local_batch_size(config.batch_size)
    steps = _epoch_steps(config.validation_size, bs, drop_remainder=False)
    all_logs, weights = [], []
    for i, (real, real_count) in enumerate(_validation_batches(
            source, len(validation_ds), bs, steps)):
        _, logs = algo.eval_step(state, real,
                                 _draws(config, i, device, bs,
                                        seed=config.seed + 777),
                                 _row_mask(bs, real_count, device))
        weights.append(logs.pop("batch/real_rows"))
        all_logs.append(logs)
    return _mean_logs(all_logs, weights=weights)


def generate_surrogate_dataset(config, algo, state, device: torch.device,
                               num_samples: int = 2 * 10**6) -> str:
    """A denormalised sample set in ``generated.pkl`` (reference
    ``utils.py:191-207``), generated about 1000 at a time: in a run of P
    data ranks ``ceil(1000 / P) * P`` rows a batch, each data index
    generating its rows of it (its model or time peers with it, the time
    peers' frames gathered) into its own shard ``generated.pkl.RRR``
    (``train.py:332-364``), written by the first of its peers."""
    world = mesh_lib.data_extent()
    batch_size = -(-1000 // world) * world
    num_samples = -(-num_samples // batch_size) * batch_size
    local_bs = batch_size // world
    generated = np.zeros((num_samples // world,)
                         + tuple(config.signal_shape), np.float32)
    for step, i in enumerate(_progress(
            range(0, num_samples, batch_size), "Surrogate",
            num_samples // batch_size, config.verbose)):
        noise = _draws(config, i, device, local_bs,
                       seed=config.seed + 999).noise(local_bs,
                                                     config.noise_dim)
        rows = pipeline.denormalize(config, mesh_lib.gather_time(
            algo.sample(state, noise)))
        generated[step * local_bs:(step + 1) * local_bs] = \
            rows.cpu().numpy()
    suffix = f".{mesh_lib.data_index():03d}" if world > 1 else ""
    filename = os.path.join(config.output_dir, f"generated.pkl{suffix}")
    if not mesh_lib.writes_shard():
        return filename
    with open(filename, "wb") as f:
        pickle.dump({"signals": generated}, f)
    if config.verbose:
        print(f"save {len(generated)} samples to {filename}")
    return filename


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def layout(config, devices) -> mesh_lib.Mesh:
    """The layout ``config`` asks of ``devices``, with the JAX trainer's
    checks (``train.py:408-442``): ``--time_parallelism T`` divides the
    device count and ``--data_parallelism -1`` takes the rest, else
    ``--data_parallelism``, ``--model_parallelism`` and ``--dcn_slices``."""
    time_par = int(getattr(config, "time_parallelism", 1) or 1)
    if time_par > 1:
        n_dev = len(devices)
        if time_par > n_dev or n_dev % time_par:
            raise ValueError(
                f"time_parallelism {time_par} must divide the device count "
                f"({n_dev} device(s) visible)")
        data_par = config.data_parallelism
        if data_par in (-1, 0, None):
            data_par = n_dev // time_par
        return mesh_lib.create_time_mesh(data_par, time_par, devices)
    return mesh_lib.create_mesh(config.data_parallelism,
                                config.model_parallelism, devices,
                                slices=config.dcn_slices)


def build_algorithm(config, device: torch.device):
    """The models and algorithm of one rank of the current layout: the two
    sequence-sized Dense layers cut to this rank's shards on a model axis
    (their names and shard shapes returned), the long-context WGAN-GP on a
    time axis."""
    from calciumgan_tpu_torch.parallel import long_context
    # the weights are drawn whole from the seed on every rank, then cut
    generator, discriminator = get_models(
        config, rng=torch.Generator().manual_seed(int(config.seed)),
        device=device)
    shards = {}
    if mesh_lib.model_group() is not None:
        shards = mesh_lib.shard_models(
            {"generator": generator, "discriminator": discriminator},
            config.model, mesh_lib.model_group())
    if mesh_lib.time_group() is not None:
        algo = long_context.make_long_context_algorithm(
            config, generator, discriminator)
    else:
        algo = get_algorithm(config, generator, discriminator)
    return algo, shards


def main(config, return_metrics: bool = False, device="cuda",
         mesh: Optional[mesh_lib.Mesh] = None) -> Optional[Dict[str, float]]:
    """End-to-end wiring (reference ``main.py:184-224``): one rank's part of
    a run over ``mesh``, whose ranks are the process group's, or without
    one the whole run on ``device``, whose one-device mesh must hold the
    configured layout."""
    if mesh is None:
        mesh = layout(config, [str(torch.device(device))])
    world, rank = len(mesh.devices), mesh_lib.process_index()
    if mesh_lib.process_count() != world:
        raise ValueError(f"mesh of {world} ranks in a process group of "
                         f"{mesh_lib.process_count()}")
    mesh_lib.init_groups(mesh)
    device = resolve_device(mesh.device)
    if rank:
        config.verbose = 0  # rank 0 speaks for the run
    if config.clear_output_dir:
        if rank == 0 and os.path.exists(config.output_dir):
            rmtree(config.output_dir)
        if mesh_lib.data_group() is not None:  # cleared before any use
            mesh_lib.collectives["barrier"] += 1
            torch.distributed.barrier()
    os.makedirs(config.output_dir, exist_ok=True)

    summary = Summary(config)
    train_ds, validation_ds = pipeline.get_datasets(config)
    config.validate_model_shapes()

    algo, shards = build_algorithm(config, device)
    generator, discriminator = algo.generator, algo.discriminator
    state = algo.init_state()
    if config.verbose:
        print(f"device: {device}" + (f" (rank 0 of {world}: "
                                     f"{', '.join(mesh.devices)})"
                                     if world > 1 else ""))
        if world > 1:
            print(f"mesh: {mesh.shape}")
        for name, shape in shards.items():
            print(f"model-sharded: {name} {shape} a rank")
        print(f"generator parameters: {count_params(generator):,}")
        print(f"discriminator parameters: {count_params(discriminator):,}")
    if config.verbose >= 2:
        print(layer_table(generator))
        print(layer_table(discriminator))
    summary.scalar("model/trainable_parameters/generator",
                   count_params(generator))
    summary.scalar("model/trainable_parameters/discriminator",
                   count_params(discriminator))

    config.save()
    config.ckpt_dir = config.ckpt_dir or os.path.join(config.output_dir,
                                                      "checkpoints")
    state = checkpoint.resume(config, state)
    plot_real_signals(config, summary, validation_ds)
    if config.save_generated:
        io.cache_validation_set(config, validation_ds)

    start = time()
    val_src = train_and_validate(config, train_ds, validation_ds, algo, state,
                                 summary, device)
    summary.scalar("elapse/total", time() - start)
    summary.flush()

    if config.surrogate_ds:
        generate_surrogate_dataset(config, algo, state, device)
    metrics = (test(config, validation_ds, algo, state, device, val_src)
               if return_metrics else None)
    summary.close()
    return metrics


def run(config, device="cuda", return_metrics: bool = False, devices=None
        ) -> Optional[Dict[str, float]]:
    """Train ``config`` over the devices its layout (:func:`layout`) takes
    of ``devices`` (default: every visible GPU for a CUDA ``device``, as
    many host ranks as the layout's axes multiply to for the CPU): in this
    process when the layout holds one device, else one rank per device
    through the launcher, over NCCL for GPUs and gloo for the host.
    Returns rank 0's metrics (every rank's are the same)."""
    resolve_device(device)  # a CUDA device without a card raises
    if devices is None:
        devices = mesh_lib.visible_devices(device, host_ranks=max(
            1, config.data_parallelism) * max(1, config.dcn_slices)
            * max(1, config.model_parallelism)
            * max(1, int(config.time_parallelism or 1)))
    mesh = layout(config, devices)
    if len(mesh.devices) == 1:
        return main(config, return_metrics, mesh=mesh)
    backend = "nccl" if mesh.device.type == "cuda" else "gloo"
    return launch_lib.launch(main, mesh.devices, backend,
                             args=(config, return_metrics, device, mesh))[0]
