"""Seconds of the set-up's ``ops.autotune.autotune`` call (host clock)."""


def read(run):
    return run.autotune_s
