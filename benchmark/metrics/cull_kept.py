"""Share of binning's (tile, splat) candidates that its tight cull keeps
(%): the program's ``bin.pairs`` over its ``bin.candidates`` counter, each
per step or frame of the traced window (``benchmark/spans.py``); 100
where every candidate is kept.  None where the program counts no
candidates."""

from benchmark import spans


def read(run):
    pairs = spans.per_step(run, "bin.pairs")
    candidates = spans.per_step(run, "bin.candidates")
    if pairs is None or not candidates:
        return None
    return 100.0 * pairs / candidates
