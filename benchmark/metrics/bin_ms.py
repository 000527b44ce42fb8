"""Stream time per step or frame (ms) of the program's ``bin`` span,
binning: candidates, tight cull, key sort, table packing and the classic
table gather (``ops/binning.py``): the card's time between the span's
two CUDA events, summed over the traced window (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "bin")
