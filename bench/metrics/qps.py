"""Queries whose results reached the host in the window, over the window's
seconds (host clock; the window ends with its last search)."""


def read(run):
    return sum(s["queries"] for s in run.searches) / run.window_s
