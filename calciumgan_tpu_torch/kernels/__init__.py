"""Building and loading the port's hand-written CUDA kernels
(:mod:`calciumgan_tpu_torch.kernels.build`)."""
