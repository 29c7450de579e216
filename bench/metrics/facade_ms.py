"""Host wall time of the program's facade and planner spans in the traced
window (``rt.pad``, ``rt.upload``, ``rt.plan``, ``rt.copy``: padding the
ragged queries, their upload, the plans and schedules, the results' copy
to the host), over the window's searches (``bench.layers``)."""
from ..layers import FACADE, per_unit


def read(run):
    return per_unit(run, "host_s", FACADE, unit="searches")
