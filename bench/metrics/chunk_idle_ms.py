"""Idle time of the device in the traced window whose gap's middle falls
in the program's chunk loop: an ``rt.chunk.test`` span (the loop's test
and its sync), an ``rt.chunk`` span or one of its steps, over the window's
chunk steps (``bench.layers``)."""
from ..layers import per_unit


def read(run):
    lay = (run.trace or {}).get("layers") or {}
    return per_unit(run, "idle_s", [n for n in lay if n == "rt.chunk"
                                    or n.startswith("rt.chunk.")])
