"""(tile, splat) pairs after binning's tight cull per step or frame: the
program's ``bin.pairs`` counter over the traced window
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.per_step(run, "bin.pairs")
