"""Synchronizing CUDA calls of one warm step or frame outside the window,
by torch's sync debug mode."""


def read(run):
    return None if run.host_syncs is None else float(run.host_syncs)
