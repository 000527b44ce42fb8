"""Stream time per step or frame (ms) of the program's ``project_bwd``
span, the backward from the packed table's gradient to the scene's: the
packing's, SH's and projection's: the card's time between the span's two
CUDA events, summed over the traced window (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "project_bwd")
