"""Stream time per step or frame (ms) of the program's ``blend`` span, the
blend after binning: the fused path's gathers and kernels or the classic
blend, tiles to image, background (``ops/raster_tiles.py``): the card's
time between the span's two CUDA events, summed over the traced window
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "blend")
