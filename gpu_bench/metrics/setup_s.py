"""Seconds from the start of the process to the first timed call:
imports, the input build, ``plan_spmv``, the kernels' build or load, and
the warm-up of the cell's own shapes (host clock)."""


def read(run):
    return run.setup_s
