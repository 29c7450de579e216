"""Device time of the operations launched inside the program's
``rt.chunk.gather`` spans (a chunk's term bounds, skip test, essential and
freeze bounds and the gather of its postings) in the traced window, over
the window's chunk steps (``bench.layers``)."""
from ..layers import per_unit


def read(run):
    return per_unit(run, "device_s", ("rt.chunk.gather",))
