"""Stream time per step or frame (ms) of the program's ``fold`` span, the
gradient fold: the fused path's id fold or the classic fold
(``ops/fused.py``, ``ops/binning.py``): the card's time between the
span's two CUDA events, summed over the traced window
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "fold")
