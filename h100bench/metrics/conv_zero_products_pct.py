"""The share of the products of the convolutions, as the program's routes
multiply them, that are not the convolutions' own work (those by the zero
taps that a 1-D layer which pads asymmetrically prepends to its kernel):
one less the program's count ``conv/work_products`` over
``conv/products`` (:mod:`h100bench.spans`), which each layer counts
whatever route it takes. A program without the counts reads None."""

from h100bench import spans


def read(ctx):
    found = spans.counters()
    if found is None or not found[0]["conv/products"]:
        return None
    totals = found[0]
    return 100.0 * (1.0 - totals["conv/work_products"]
                    / totals["conv/products"])
