"""Device time of the operations launched inside the program's
``rt.chunk.select`` (each tile's top-k of the three queues and its stats)
and ``rt.chunk.merge`` spans (the merge into the carried queues and the
stat sums) in the traced window, over the window's chunk steps
(``bench.layers``)."""
from ..layers import per_unit


def read(run):
    return per_unit(run, "device_s", ("rt.chunk.select", "rt.chunk.merge"))
