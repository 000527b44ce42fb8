"""Stream time per step or frame (ms) of the program's ``blend_bwd`` span,
the blend's backward up to the fold: cotangents and B5 twice, or B3
(``ops/fused.py``, ``ops/blend.py``): the card's time between the span's
two CUDA events, summed over the traced window (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "blend_bwd")
