"""Mean over the window's searches of the chunk loop's trip count: the
largest ``stats["chunks_dispatched"]`` of a search's rows (the program's
own counter; the loop runs while any row's next chunk can qualify)."""


def read(run):
    if not run.searches:
        return None
    return sum(s["steps"] for s in run.searches) / len(run.searches)
