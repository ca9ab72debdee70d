"""Host milliseconds a served batch spends on its layout passes: the
program's span ``generate/layout`` (the transpose of the signals to traces
on the device, and of the spikes back on the host), over its batches
(:mod:`h100bench.spans`)."""

from h100bench import spans


def read(ctx):
    return spans.ms_per(("generate/layout",), "generate/batch")
