"""Device memory the program's index build leaves allocated
(``torch.cuda.memory_allocated()`` after the build, host copies freed,
less before it), over the number of docs."""


def read(run):
    if run.index_bytes <= 0:
        return None
    return run.index_bytes / run.n_docs
