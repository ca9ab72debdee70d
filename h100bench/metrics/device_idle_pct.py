"""The device's idle share in the traced steps or batches: one less the
union of each device's intervals over its traced wall time, averaged over
the chips."""


def read(ctx):
    traces = [t for t in ctx.get("traces") or [] if t]
    if not traces:
        return None
    return 100.0 * sum(1.0 - t["busy_s"] / t["window_s"]
                       for t in traces) / len(traces)
