"""Process start to the first timed search: corpus generation, the
program's index build, kernel build or load, warm-up (host clock)."""


def read(run):
    return run.setup_s
