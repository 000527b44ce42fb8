from gaussiansplattingviewer_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_host_mesh,
    make_mesh,
    replicate_scene,
)
from gaussiansplattingviewer_tpu_torch.parallel.sharded_render import (
    all_reduce_grads,
    make_sharded_render_fn,
    make_sharded_train_step,
    render_sharded,
    shard_scene_splats,
)

__all__ = [
    "Mesh",
    "all_reduce_grads",
    "initialize_distributed",
    "make_host_mesh",
    "make_mesh",
    "make_sharded_render_fn",
    "make_sharded_train_step",
    "render_sharded",
    "replicate_scene",
    "shard_scene_splats",
]
