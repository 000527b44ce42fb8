"""Render configuration for the PyTorch/CUDA splatting pipeline.

Same fields, defaults and properties as the JAX package's ``RenderConfig``,
so a config can be carried across with
``RenderConfig(**dataclasses.asdict(other))`` (``mode`` may be the other
package's enum: it is converted by value).

Fields that exist only to shape the TPU binning (the duplicate-slot pools:
``dup_factor``, ``dense_*``, ``pool_*``) are accepted and have NO effect here:
the port bins with an exact count -> scan -> expand -> sort pipeline whose
buffers are sized by the live duplicate count (ops/binning.py).
"""

from __future__ import annotations

import dataclasses
import enum


class RenderMode(enum.IntEnum):
    """Render modes, numerically identical to the reference's ``render_mod``.

      ``mod >= 0``  SH bands 0..mod (SH:0, SH:0~1, SH:0~2, SH:0~3)
      ``mod == -1`` stereo-disparity image
      ``mod == -2`` billboard: solid quad, alpha=1
      ``mod == -3`` flat ball: alpha thresholded at 0.22
      ``mod == -4`` gaussian ball: thresholded + darkened by exp(power)
    """

    SH0 = 0
    SH1 = 1
    SH2 = 2
    SH3 = 3
    DEPTH = -1
    BILLBOARD = -2
    FLAT_BALL = -3
    GAUSSIAN_BALL = -4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.

    Attributes that change the image (see the JAX package's docstring for
    the reference line of each constant):
      width, height: output resolution in pixels (reference 1160x522).
      mode: RenderMode; default SH3.
      scale_modifier: global multiplier on Gaussian scales.
      tile_size: rasterizer tile edge; the CUDA blend kernel takes 16 only.
      max_tiles_per_gaussian: optional cap on tiles per splat (0 = none);
        clamped splats are counted in the ``overflow`` diagnostic.
      table_budget_rows / table_budget_factor: rows of the materialized
        splat table (0 = factor * N); the sorted tail past the budget is
        dropped and counted in ``truncated``.
      stereo_baseline, depth_scale_inflate: DEPTH-mode constants.
      background: background intensity for all three channels.
      clamp_color: clamp per-splat RGB at 0 after the +0.5 SH offset.
      ndc_cull_limit, alpha_clamp, alpha_min, ball_threshold,
      early_stop_transmittance: the reference's fragment constants.
      tight_culling: drop candidate tiles whose best pixel alpha is below
        alpha_min (changes no output; off in BILLBOARD mode).
      debug: render_with_aux also reports non-finite splat/pixel counts.
      grad_fold_bf16: the binning gradient fold rounds each table row's
        gradient to bf16 before summing it onto its splat (the JAX default).

    The fused prefix/residual path (ops/fused.py; set by
    ops/autotune.py at garden scale):
      fused_grad: render through it instead of bin_splats + blend_tiles.
      prefix_rows: K, the rows of each tile blended in pass 1 (0 = one
        full pass); residual_budget_rows must then be set.
      prefix_budget_rows / residual_budget_rows: rows gathered by pass 1
        (0 = the table budget) and pass 2; the excess is dropped and
        counted in ``truncated``.
      grad_budget_rows / grad_residual_budget_rows: compact gradient rows
        of each pass (0 = a safe bound); tiles past it lose their gradients
        for the step, counted in ``grad_rows_dropped``.

    Accepted for compatibility, no effect in the port: dup_factor,
    dense_small_slots, dense_mid_slots, dense_big_slots, pool_*_fraction,
    pool_ladder and pool_huge_entries (TPU scatter avoidance; the
    autotuner still writes and reads them, see ops/autotune.py).
    """

    width: int = 1160
    height: int = 522
    mode: RenderMode = RenderMode.SH3
    scale_modifier: float = 1.0
    tile_size: int = 16
    max_tiles_per_gaussian: int = 0
    dup_factor: int = 16
    dense_small_slots: int = 4
    dense_mid_slots: int = 4
    dense_big_slots: int = 128
    pool_mid_fraction: int = 8
    pool_full_fraction: int = 16
    pool_big_fraction: int = 512
    pool_huge_fraction: int = 16384
    pool_ladder: tuple = ()
    pool_huge_entries: int = 0
    table_budget_rows: int = 0
    table_budget_factor: int = 8
    stereo_baseline: float = -0.5
    depth_scale_inflate: float = 1.2
    background: float = 0.0
    clamp_color: bool = True
    ndc_cull_limit: float = 1.3
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    ball_threshold: float = 0.22
    early_stop_transmittance: float = 1e-4
    fused_grad: bool = False
    prefix_rows: int = 0
    prefix_budget_rows: int = 0
    residual_budget_rows: int = 0
    grad_budget_rows: int = 0
    grad_residual_budget_rows: int = 0
    tight_culling: bool = True
    grad_fold_bf16: bool = True
    debug: bool = False

    def __post_init__(self):
        object.__setattr__(self, "mode", RenderMode(int(self.mode)))

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
