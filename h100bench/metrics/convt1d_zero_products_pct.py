"""The share of the products of the 1-D transposed convolutions, as the
program's routes multiply them, that are not the transposed convolutions'
own work: the products that land in the frames a layer crops from its
whole output, where ``K + s`` is odd (WaveGAN's 25 taps at stride 4).
One less the program's count ``conv_transpose1d/work_products`` over
``conv_transpose1d/products`` (:mod:`h100bench.spans`), which each 1-D
layer counts whatever route it takes. A program without the counts reads
None."""

from h100bench import spans


def read(ctx):
    found = spans.counters()
    if found is None or not found[0]["conv_transpose1d/products"]:
        return None
    totals = found[0]
    return 100.0 * (1.0 - totals["conv_transpose1d/work_products"]
                    / totals["conv_transpose1d/products"])
