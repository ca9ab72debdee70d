"""Host milliseconds a served batch spends redoing its flagged traces in
float64: the program's span ``oasis/redo`` (the flagged rows' copy to the
host and the C++ kernel on the host's cores), over its batches
(:mod:`h100bench.spans`)."""

from h100bench import spans


def read(ctx):
    return spans.ms_per(("oasis/redo",), "generate/batch")
