"""Evaluation (counterpart of :mod:`calciumgan_tpu.eval`); only the
deconvolution entry point is ported so far."""
