"""Device time per step or frame (ms): the union of the traced window's
device operations over its steps or frames."""


def read(run):
    if not run.events or not run.steps:
        return None
    return run.trace["busy_s"] * 1e3 / run.steps
