"""Seconds of the one ``plan_spmv`` call in set-up, to its last device
copy (host clock): the planner's host analysis and the pack."""


def read(run):
    return run.spans.get("plan_s")
