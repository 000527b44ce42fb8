"""Share of the traced window in which no kernel or copy ran on the card
(%), from the profiler's CUDA activity."""


def read(run):
    if not run.events or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)
