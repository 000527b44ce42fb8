"""Stream time per step or frame (ms) of the program's ``project`` span,
projection and SH (``ops/projection.py``): the card's time between the
span's two CUDA events, summed over the traced window
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "project")
