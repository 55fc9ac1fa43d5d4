"""The 90th percentile of every solve's wall time in the window, each
timed from its call to a synchronise after it returns (host clock)."""

import statistics


def read(run):
    durations = run.window.durations
    if not durations:
        return None
    if len(durations) < 2:
        return durations[0]
    return statistics.quantiles(durations, n=10)[8]
