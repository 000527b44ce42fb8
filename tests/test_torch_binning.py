"""PyTorch port: tile binning against the JAX package's bin_splats on the
same projected splats (JAX's own projection, carried across as numpy).

Tile starts and counts are integer-equal and the table's columns 0-11 are
bit-equal over the live rows (JAX reports overflow == truncated == 0 here);
columns 12-15 are JAX's binning scratch, which the blend never reads."""

import numpy as np
import pytest

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.ops.binning import bin_splats as jax_bin
from gaussiansplattingviewer_tpu.ops.binning import tile_bbox as jax_tile_bbox
from gaussiansplattingviewer_tpu.ops.pallas.tile_raster_fwd import (
    rasterize_binned_pallas_soa,
)
from gaussiansplattingviewer_tpu.ops.projection import project as jax_project
from gaussiansplattingviewer_tpu.utils import transforms as jtf
from gaussiansplattingviewer_tpu_torch.ops.binning import bin_splats, tile_bbox
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
    tile_raster_fwd_plain,
)
from torch_port_util import both_splats, port_cfg, splats_numpy


@pytest.mark.parametrize("mode,tight", [
    (JaxMode.SH3, True),
    (JaxMode.DEPTH, True),
    (JaxMode.BILLBOARD, True),  # tight culling is off in billboard mode
    (JaxMode.SH3, False),
])
def test_binning_matches_jax(medium_scene, small_camera, mode, tight):
    cfg = JaxConfig(width=160, height=96, mode=mode, tight_culling=tight)
    jax_s, port_s = _jax_splats(medium_scene, small_camera, cfg)
    want = jax_bin(jax_s, cfg)
    got = bin_splats(port_s, port_cfg(cfg))
    assert int(want.overflow) == 0 and int(want.truncated) == 0
    assert int(got.overflow) == 0 and int(got.truncated) == 0
    starts = np.asarray(want.tile_starts)
    np.testing.assert_array_equal(got.tile_starts.numpy(), starts)
    np.testing.assert_array_equal(got.tile_counts.numpy(),
                                  np.asarray(want.tile_counts))
    total = int(starts[-1])
    assert total > 1000
    assert int(got.num_duplicates) == int(want.num_duplicates) == total
    np.testing.assert_array_equal(
        got.table[:12, :total].numpy(),
        np.asarray(want.table)[:12, :total])
    assert got.table.shape[1] >= total + 512  # the kernels' window pad


def _jax_splats(medium_scene, small_camera, cfg):
    eye = np.array([0.4, -0.3, 6.0], np.float32)
    view = jtf.look_at(eye, [0, 0, 0], [0, -1, 0])
    splats = jax_project(medium_scene.to_device(), view,
                         small_camera.get_project_matrix(), eye, cfg)
    return both_splats(splats_numpy(splats))


@pytest.mark.parametrize("ty_lo,ty_hi,stride", [(0, 6, 1), (2, 5, 1),
                                                (1, 6, 2)])
def test_tile_bbox_cap_and_band_match_jax(medium_scene, small_camera, ty_lo,
                                          ty_hi, stride):
    """The static duplicate cap (recentred window) and the shard row set."""
    cfg = JaxConfig(width=160, height=96, max_tiles_per_gaussian=2,
                    scale_modifier=6.0)
    jax_s, port_s = _jax_splats(medium_scene, small_camera, cfg)
    want = jax_tile_bbox(jax_s, cfg, ty_lo=ty_lo, ty_hi=ty_hi,
                         row_stride=stride)
    got = tile_bbox(port_s, port_cfg(cfg), ty_lo=ty_lo, ty_hi=ty_hi,
                    row_stride=stride)
    assert int(np.asarray(want[5]).sum()) > 50  # the cap is exercised
    for name, g, w in zip(("x0", "y0", "w", "h", "count", "overflowed"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_band_binning_and_blend_match_jax(medium_scene, small_camera):
    """An interleaved shard (rows 1, 3, 5): binning bit-equal, blend within
    1e-5 of the Pallas kernel at the same row_offset / row_stride."""
    cfg = JaxConfig(width=160, height=96)
    jax_s, port_s = _jax_splats(medium_scene, small_camera, cfg)
    kw = dict(row_offset=1, local_rows=3, row_stride=2)
    want = jax_bin(jax_s, cfg, **kw)
    got = bin_splats(port_s, port_cfg(cfg), **kw)
    starts = np.asarray(want.tile_starts)
    np.testing.assert_array_equal(got.tile_starts.numpy(), starts)
    total = int(starts[-1])
    assert total > 300
    np.testing.assert_array_equal(got.table[:12, :total].numpy(),
                                  np.asarray(want.table)[:12, :total])
    j_rgb, j_t = rasterize_binned_pallas_soa(
        want.table, want.tile_starts, want.tile_counts, 1, cfg, 3, 2)
    p_rgb, p_t = tile_raster_fwd_plain(
        got.table, got.tile_starts, got.tile_counts, 1, port_cfg(cfg), 3, 2)
    assert float(np.asarray(j_rgb).max()) > 0.1
    np.testing.assert_allclose(p_rgb.numpy(), np.asarray(j_rgb), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(j_t), atol=1e-5,
                               rtol=0)
