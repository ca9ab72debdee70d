"""The OASIS kernels' share of their memory roofline in the traced
batches: OASIS's work bytes (``work.oasis_bytes``, once a batch whatever
the rungs rerun) at the HBM peak, over the device time of every kernel
whose name holds ``oasis`` in the profiler's trace."""

from h100bench import work


def read(ctx):
    window = (ctx.get("traces") or [None])[0]
    if not window or "oasis_bytes_per_batch" not in ctx:
        return None
    seconds = sum(s for name, s in window["kernel_seconds"].items()
                  if "oasis" in name.lower())
    if seconds <= 0:
        return None
    least = (ctx["oasis_bytes_per_batch"] * ctx["traced_batches"]
             / work.PEAKS["hbm_bytes_per_s"])
    return 100.0 * least / seconds
