"""Ops (counterpart of :mod:`calciumgan_tpu.ops`): the OASIS AR(1) kernel
(:mod:`.oasis_cuda`), its plain PyTorch version (:mod:`.oasis_torch`),
the host-side dispatch and the in-graph API with its while machine
(:mod:`.oasis`) and the float64 golden model they are held to
(:mod:`.golden`); the phase shuffle and the train-time signal
metrics."""
