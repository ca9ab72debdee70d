"""Device milliseconds a training step spends in backward-data
convolutions: the device time of every kernel whose name holds ``dgrad``
(cuDNN's and CUTLASS's input gradients) in the first traced window, over
its ``traced_steps``."""


def read(ctx):
    window = (ctx.get("traces") or [None])[0]
    if not window or not ctx.get("traced_steps"):
        return None
    seconds = sum(s for name, s in window["kernel_seconds"].items()
                  if "dgrad" in name.lower())
    if seconds <= 0:
        return None
    return 1e3 * seconds / ctx["traced_steps"]
