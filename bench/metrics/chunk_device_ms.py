"""Device busy time of the traced window (the union of its kernels,
copies and sets) over the chunk steps of the window's searches."""


def read(run):
    steps = sum(s["steps"] for s in run.searches)
    if run.trace is None or steps == 0:
        return None
    return run.trace["busy_s"] * 1e3 / steps
