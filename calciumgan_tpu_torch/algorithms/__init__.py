"""GAN algorithms (counterpart of :mod:`calciumgan_tpu.algorithms`); only
the inference half of :mod:`calciumgan_tpu_torch.algorithms.gan` is ported
so far."""
