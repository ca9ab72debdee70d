"""Train CalciumGAN with the PyTorch port (counterpart of ``main.py`` at the
repo root; same flags and defaults, plus ``--device`` and Adam's
``--adam_beta1``/``--adam_beta2``).

    python -m calciumgan_tpu_torch.main --input_dir dataset/tfrecords \\
        --output_dir runs/001 --batch_size 128 --num_units 64 --m 10 \\
        --layer_norm --mixed_precision --device cuda

Trains on ``--device`` (default ``cuda``; ``--device cpu`` runs on the
host; ``cuda`` without a card raises). Checkpoints are the port's own
``<output_dir>/checkpoints/epoch-NNN.pt``, resumed automatically and served
by ``python -m calciumgan_tpu_torch.generate``. ``--save_generated
all|last`` writes the validation cache, the epoch files and ``info.pkl``
under ``<output_dir>/generated``, which ``python -m
calciumgan_tpu_torch.compute_metrics`` evaluates.

Parallelism, one process (rank) per GPU:

- ``--data_parallelism N`` (default -1: every visible GPU) and
  ``--dcn_slices S`` split the global batch between N ranks, laid out as
  the JAX package's mesh does, with its checks ("mesh needs 2 devices,
  have 1"); a layout of more than one device is started on
  ``cuda:0..N-1`` over NCCL (``--device cpu``: host ranks over gloo), a
  layout of one trains in this process;
- ``--model_parallelism M`` gives each data index M ranks that share the
  two sequence-sized Dense kernels (the generator's input projection by
  output columns, the critic's head by input rows);
- ``--time_parallelism T`` (``calciumgan``, ``wgan-gp``, no BatchNorm)
  gives each data index T ranks that share every sequence's frames, with
  halo exchanges between neighbours; ``--data_parallelism -1`` then takes
  the devices T leaves;
- ``--distributed`` joins the ranks ``torchrun`` started instead
  (``torchrun --nproc_per_node 8 -m calciumgan_tpu_torch.main ...
  --distributed``): rank i on ``cuda:LOCAL_RANK``, the layout over every
  rank of the group.
"""

import argparse

from calciumgan_tpu_torch.config import Config


def _parse(argv=None):
    """``(config, device, distributed)`` from the command line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", default="dataset/tfrecords", type=str)
    parser.add_argument("--output_dir", default="runs", type=str)
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--num_units", default=32, type=int)
    parser.add_argument("--kernel_size", default=24, type=int)
    parser.add_argument("--strides", default=2, type=int)
    parser.add_argument("--m", default=2, type=int,
                        help="phase shuffle shift (temporal)")
    parser.add_argument("--n", default=2, type=int,
                        help="phase shuffle shift (neuron axis, 2d model)")
    parser.add_argument("--epochs", default=20, type=int)
    parser.add_argument("--dropout", default=0.2, type=float)
    parser.add_argument("--learning_rate", default=1e-4, type=float)
    parser.add_argument("--noise_dim", default=32, type=int)
    parser.add_argument("--gradient_penalty", default=10.0, type=float)
    parser.add_argument("--model", default="calciumgan", type=str)
    parser.add_argument("--activation", default="leakyrelu", type=str)
    parser.add_argument("--batch_norm", action="store_true")
    parser.add_argument("--layer_norm", action="store_true")
    parser.add_argument("--algorithm", default="wgan-gp", type=str)
    parser.add_argument("--n_critic", default=5, type=int)
    parser.add_argument("--ema", default=0.0, type=float,
                        help="generator-EMA decay per generator update "
                             "(0 = off, typical 0.999)")
    parser.add_argument("--clear_output_dir", action="store_true")
    parser.add_argument("--save_generated", default="", type=str,
                        choices=["", "last", "all"])
    parser.add_argument("--plot_weights", action="store_true")
    parser.add_argument("--skip_checkpoints", action="store_true")
    parser.add_argument("--mixed_precision", action="store_true",
                        help="bfloat16 compute (no loss scaling needed)")
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler window at epoch 1, batches 2-6")
    parser.add_argument("--dpi", default=120, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--seed", default=1234, type=int)
    parser.add_argument("--data_parallelism", default=-1, type=int,
                        help="-1: all visible devices")
    parser.add_argument("--model_parallelism", default=1, type=int)
    parser.add_argument("--time_parallelism", default=1, type=int)
    parser.add_argument("--dcn_slices", default=1, type=int,
                        help="an outer slice axis of the data layout "
                             "(ranks slice-major)")
    parser.add_argument("--checkpoint_every", default=10, type=int)
    parser.add_argument("--device_store", default="auto",
                        choices=["auto", "on", "off"],
                        help="keep the dataset signals on the device and "
                             "gather batches there (auto: a GPU and the "
                             "signals fit --device_store_mb)")
    parser.add_argument("--device_store_mb", default=4096, type=int)
    parser.add_argument("--adam_beta1", default=0.9, type=float)
    parser.add_argument("--adam_beta2", default=0.999, type=float,
                        help="Adam's betas (WaveGAN's recipe: 0.5, 0.9)")
    parser.add_argument("--distributed", action="store_true",
                        help="join the ranks torchrun started (RANK, "
                             "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on")
    args = parser.parse_args(argv)
    device = args.device
    # how a run starts is not a hyper-parameter
    distributed = args.distributed
    del args.device, args.distributed

    config = Config.from_args(args)
    # the reference flags surrogate datasets by directory name
    config.surrogate_ds = "surrogate" in config.input_dir
    return config, device, distributed


def parse_args(argv=None):
    """``(config, device)`` from the command line."""
    config, device, _ = _parse(argv)
    return config, device


def cli(argv=None):
    from calciumgan_tpu_torch import train
    from calciumgan_tpu_torch.parallel import launch
    config, device, distributed = _parse(argv)
    if not distributed:
        return train.run(config, device=device)
    devices = launch.join(device)
    try:
        layout = train.layout(config, devices)
        if len(layout.devices) != len(devices):
            raise ValueError(f"--distributed: the layout takes "
                             f"{len(layout.devices)} of the group's "
                             f"{len(devices)} ranks")
        return train.main(config, mesh=layout)
    finally:
        launch.leave()


if __name__ == "__main__":
    cli()
