"""``2 * nnz * nrhs`` over every product completed in the window (the
kind's ``flops`` counter), divided by the window's seconds (host clock,
ending in a synchronise)."""


def read(run):
    flops = run.window.counters.get("flops")
    if flops is None:
        return None
    return flops / run.window.seconds / 1e9
