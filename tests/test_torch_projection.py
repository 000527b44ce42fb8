"""PyTorch port: projection against the JAX package's project() in every
render mode.

Floats agree to rtol=atol=1e-5: the 3x3 and 4x4 products sum in another
order in torch than in XLA.  ``valid`` is compared exactly."""

import numpy as np
import pytest

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.ops.projection import project as jax_project
from gaussiansplattingviewer_tpu.utils import transforms as jtf
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from torch_port_util import SPLAT_FIELDS, port_cfg, port_scene, splats_numpy


@pytest.mark.parametrize("mode", list(JaxMode))
def test_projection_matches_jax(medium_scene, small_camera, mode):
    cfg = JaxConfig(width=160, height=96, mode=mode)
    eye = np.array([0.4, -0.3, 6.0], np.float32)
    view = jtf.look_at(eye, [0, 0, 0], [0, -1, 0])
    proj = small_camera.get_project_matrix()
    scene = medium_scene.to_device()
    want = splats_numpy(jax_project(scene, view, proj, eye, cfg))
    got = splats_numpy(project(port_scene(scene), view, proj, eye,
                               port_cfg(cfg)))
    assert want["valid"].sum() > 500  # the scene is mostly in view
    for f in SPLAT_FIELDS:
        assert got[f].shape == want[f].shape, f
        assert got[f].dtype == want[f].dtype, f
        if f == "valid":
            np.testing.assert_array_equal(got[f], want[f])
        else:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{mode.name} {f}")
