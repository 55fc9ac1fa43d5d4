"""Mean of ``CGResult.iterations`` over the window's solves (an exact
count from the solver, which the kind counts in the window)."""


def read(run):
    its = run.window.counters.get("iterations")
    if not its:
        return None
    return sum(int(i) for i in its) / len(its)
