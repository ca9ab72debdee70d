"""A served batch's share of its roofline: the least device time of a
batch (the generator's FLOPs at the bf16 peak plus OASIS's bytes at the
HBM peak, ``work.generate_batch_seconds``) over the measured time a
batch."""


def read(ctx):
    if "batch_least_s" not in ctx or not ctx["batches"]:
        return None
    return 100.0 * ctx["batch_least_s"] * ctx["batches"] / ctx["window_s"]
