from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    render_camera,
    render_with_aux,
)

__all__ = ["render", "render_camera", "render_with_aux"]
