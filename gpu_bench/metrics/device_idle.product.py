"""Share of the traced window of a product cell with no device op
running (torch.profiler)."""


def read(run):
    return run.trace.idle_pct if run.trace is not None else None
