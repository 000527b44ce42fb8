"""Process groups for tile-row-sharded rendering on ``torch.distributed``
(the port of the JAX package's ``parallel/mesh.py``).

The JAX package shards one program over a device mesh.  Here each device is
one process (one rank) that holds its own tensors: the scene, replicated or
a splat shard, and the image rows of its band of tile rows.  The ranks meet
in one process group: NCCL for CUDA, gloo for the CPU.  Launch one process
per device, e.g. ``torchrun --nproc-per-node N``, or pass the rendezvous
explicitly (``initialize_distributed``).

Not ported: ``put_global``, which builds one global array from host values
on a multi-process mesh (each rank already holds its own tensors), and
``tile_axes`` (the group is flat; see ``make_host_mesh``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from gaussiansplattingviewer_tpu_torch.models.gaussians import (
    _FIELDS,
    GaussianData,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The group the tile rows are sharded over: ``group`` (None is the
    default group), this process's ``rank`` in it, ``world_size`` ranks,
    and the ``device`` this rank renders on."""

    group: object
    rank: int
    world_size: int
    device: torch.device


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None):
    """Join the default process group (``init_process_group``) once per
    process; a no-op when it exists already.

    Without arguments the launcher's environment is read: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``
    (``torchrun`` sets them).  Otherwise pass ``coordinator_address`` (a
    ``host:port`` or an init URL such as ``file:///path``), the world size
    ``num_processes`` and this ``process_id``.  ``device`` "cuda" (default)
    takes NCCL and selects card ``LOCAL_RANK``; "cpu" takes gloo.

    Returns (rank, world_size)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "for a gloo group on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              if dev.index is None else dev.index)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=coordinator_address
                  if "://" in coordinator_address
                  else f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The default group as a 1-D mesh of tile-row shards.  ``n_devices``,
    when given, must equal the world size (one process per device).  The
    device defaults to the current card under NCCL and to the CPU under
    gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() "
                           "in every process first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} "
                         f"processes, the group has {world}")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
    return Mesh(group=None, rank=dist.get_rank(), world_size=world,
                device=torch.device(device))


def make_host_mesh(n_hosts: int | None = None, device=None) -> Mesh:
    """The JAX package's 2-level (hosts, chips) mesh becomes ONE flat
    group over every rank of every host: NCCL picks the links between and
    within hosts itself, and the render shards tile rows over all ranks
    either way.  ``n_hosts``, when given, must divide the world size."""
    mesh = make_mesh(device=device)
    if n_hosts is not None and mesh.world_size % n_hosts:
        raise ValueError(f"{mesh.world_size} ranks not divisible by "
                         f"{n_hosts} hosts")
    return mesh


def replicate_scene(scene: GaussianData, mesh: Mesh) -> GaussianData:
    """Rank 0's scene on every rank, on each rank's device.  Every rank
    passes a scene of the same shape; its values are replaced."""
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None \
        else 0
    out = []
    for f in _FIELDS:
        t = getattr(scene, f).detach().to(mesh.device).contiguous().clone()
        dist.broadcast(t, src=src, group=mesh.group)
        out.append(t)
    return GaussianData(*out)
