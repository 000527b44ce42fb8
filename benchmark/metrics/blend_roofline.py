"""Share of the blend kernels' roofline (%): the least time the card could
take to blend what the window's steps or frames need (``roofline``, from
the reference's count of needed fragments, mean over the poses it
rendered, and its work per fragment) over the traced device time of
kernels B1-B5."""

from benchmark import roofline


def read(run):
    if not run.events or not run.needed or run.trace["blend_s"] <= 0:
        return None
    bound = roofline.blend_bound_s(run.needed, run.kind == "train",
                                   run.work)
    return 100.0 * bound * run.steps / run.trace["blend_s"]
