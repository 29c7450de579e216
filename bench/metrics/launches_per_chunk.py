"""Kernel launches the host made in the traced window (the profiler's
``cudaLaunchKernel`` and driver launch events) over the chunk steps of the
window's searches."""


def read(run):
    steps = sum(s["steps"] for s in run.searches)
    if run.trace is None or steps == 0:
        return None
    return run.trace["launches"] / steps
