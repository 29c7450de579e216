"""Share of the chunk loop's row steps that were live: the sum over a
search's rows of ``stats["chunks_dispatched"]`` (the chunks whose bound
could still beat the row's threshold) over rows times the loop's trip
count, over the window (the program's own counters). The rest is work the
batch does for rows that have already finished."""


def read(run):
    steps = sum(s["steps"] * s["queries"] for s in run.searches)
    if steps == 0:
        return None
    return 100.0 * sum(s["row_chunks"] for s in run.searches) / steps
