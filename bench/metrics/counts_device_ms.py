"""Device time of the operations launched inside the program's
``rt.chunk.counts`` spans (``_offs_counts``: present slots and postings of
each visited tile, a scatter over every gathered entry) in the traced
window, over the window's chunk steps (``bench.layers``)."""
from ..layers import per_unit


def read(run):
    return per_unit(run, "device_s", ("rt.chunk.counts",))
