"""Milliseconds per application of the preconditioner, from the CUDA
events that the solve kind records around each call of the callable it
passes as ``precond=`` in a traced window (read after the window, no
synchronise inside it): the window's span ``vcycle_ms``."""


def read(run):
    ms = run.window.spans.get("vcycle_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
