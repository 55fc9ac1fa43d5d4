"""Share of the traced window of a solve cell with no device op running
(torch.profiler)."""


def read(run):
    return run.trace.idle_pct if run.trace is not None else None
