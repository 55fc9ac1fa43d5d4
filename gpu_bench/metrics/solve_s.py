"""The whole window over the solves completed in it (host clock; the
last solve runs to its end)."""


def read(run):
    return run.window.seconds / run.window.calls
