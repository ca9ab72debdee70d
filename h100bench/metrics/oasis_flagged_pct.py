"""The share of the traces the OASIS kernel took that it flagged for the
float64 redo: the program's counts ``oasis/flagged`` over ``oasis/traces``
(:mod:`h100bench.spans`), the work redone over the work attempted."""

from h100bench import spans


def read(ctx):
    found = spans.counters()
    if found is None or not found[0]["oasis/traces"]:
        return None
    totals = found[0]
    return 100.0 * totals["oasis/flagged"] / totals["oasis/traces"]
