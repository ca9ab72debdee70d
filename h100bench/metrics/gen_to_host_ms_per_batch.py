"""Host milliseconds a served batch spends bringing its results to the
host: the program's spans ``generate/signals_to_host`` (the signals'
pageable copy, which first waits for the generator's work on the device)
and ``oasis/spikes_to_host`` (the spikes' int8 copy), over its batches
(:mod:`h100bench.spans`)."""

from h100bench import spans


def read(ctx):
    return spans.ms_per(("generate/signals_to_host", "oasis/spikes_to_host"),
                        "generate/batch")
