"""Share of kernel P1s's memory bound (%): the bytes the surfel projection
must move per frame (the reference's ``WORK["splat_bytes"]`` per surfel
times the scene's surfels) over the HBM peak (``roofline.py``), against
the traced device time of ``project_surfel_fwd_kernel`` per frame.  None
where the run has no such kernel or its reference no such count."""

from benchmark import roofline

KERNEL = "project_surfel_fwd_kernel"


def read(run):
    per_splat = (getattr(run, "work", None) or {}).get("splat_bytes")
    if not run.events or not run.steps or not per_splat:
        return None
    seconds = sum(end - start for name, start, end in run.events
                  if KERNEL in name)
    if seconds <= 0:
        return None
    bound = run.n_splats * per_splat / roofline.PEAK_HBM_BYTES
    return 100.0 * bound * run.steps / seconds
