"""The share of the products of the generator's 2-D transposed
convolutions, as the program's routes multiply them, that are not the
transposed convolutions' own work (those by the zeros of a dilated input):
one less the program's count ``conv_transpose2d/work_products`` over
``conv_transpose2d/products`` (:mod:`h100bench.spans`), which each layer
counts whatever route it takes. A program without the counts reads
None."""

from h100bench import spans


def read(ctx):
    found = spans.counters()
    if found is None or not found[0]["conv_transpose2d/products"]:
        return None
    totals = found[0]
    return 100.0 * (1.0 - totals["conv_transpose2d/work_products"]
                    / totals["conv_transpose2d/products"])
