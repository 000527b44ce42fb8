// Tile blend forward: front-to-back alpha blending of the depth-sorted
// splat rows of each tile.  One kernel template, four entry points:
//
//   gsv_tile_raster_fwd               kernel B1, the inference blend;
//   gsv_tile_raster_fwd_train         kernel B2, B1 plus the backward's
//                                     residuals;
//   gsv_tile_raster_fwd_seeded        kernel B4, the fused path's residual
//   gsv_tile_raster_fwd_seeded_train  pass (inference and train variants).
//
// Tile sizes: B1, B2 and the inference B4 take 8x8, 16x16 and 32x32
// tiles, as the JAX package's XLA executor does for training
// (ops/blend.py); the backward B3 takes the same.  B4 train, like the
// fused backward B5, takes 16x16 only: JAX's fused path runs only through
// Pallas (ops/raster_tiles.py:68), whose train kernel lays its checkpoint
// out for 256 pixels (ops/pallas/tile_raster_fwd.py:334).  The text below
// describes the 16x16 tile; Geo<TILE> gives the other sizes' geometry, and
// "Other tile sizes" below what differs there.
//
// Replaces: gaussiansplattingviewer_tpu/ops/pallas/tile_raster_fwd.py,
// _fwd_kernel (seeded=False) as launched by rasterize_binned_pallas_soa
// (with_ckpt=False, B1) and by rasterize_binned_pallas_train
// (with_ckpt=True, B2); _fwd_kernel(seeded=True) as launched by
// rasterize_binned_pallas_seeded (B4, train=False/True).
//
// B4 (SEEDED) differs in one place: each pixel's transmittance starts from
// t_init[t * P + p] with P = TILE * TILE (pass 1's exit transmittance,
// ops/fused.py) instead of 1.0, while rgb still accumulates from zero (the
// caller adds pass 1's rgb).  Exact by associativity of front-to-back
// compositing.  The tile's first block keeps no checkpoint here either: the
// backward (B5) takes its entering T from t_init.
//
// Semantics are the TPU kernel's: tile t blends table columns
// [starts[t], starts[t] + counts[t]) read in 256-row windows aligned to
// 128 rows; the tile stops when, after a window, no pixel of the tile has
// transmittance above early_stop (tile-wide and window-granular, NOT the
// CUDA library's per-pixel stop).  The fragment math is _chunk_blend's:
// power, the 3-sigma rect test, alpha = min(alpha_clamp, op * exp(power))
// kept iff power <= 0 and alpha >= alpha_min; billboard alpha = 1 in the
// rect; ball modes alpha = 1 above ball_threshold; gaussian ball darkens
// the weight by exp(power).  rgb += alpha * T * c; T *= 1 - alpha.
//
// B2's residuals, in the JAX layout:
//   nproc[t]  the windows the tile processed before its early stop;
//   ckpt      (ceil(P / 128), dpad): pixel p's transmittance ENTERING the
//             128-row block that starts at column c is ckpt[p / 128][c +
//             p % 128] (at 8x8, columns c + 64 .. c + 127 stay 0).  Each
//             block writes its EXITING T at the next block's columns, so a
//             tile never writes its own first block (entering T is 1.0).
// Write races: on the TPU the grid runs tiles in order and a later tile's
// write may overwrite an earlier tile's overhang; here CTAs run
// concurrently.  So a tile writes the checkpoint of block c only when c
// holds one of its own live rows (c < end).  Every written window then has
// exactly one writer: tile A writes windows c with base_A < c < end_A,
// and the next non-empty tile B starts at start_B >= end_A with
// base_B > start_B - 128, so B's windows satisfy c >= base_B + 128 >
// start_B >= end_A.  Two tiles that share a 128-row window share it as
// the later tile's first block, which nobody writes.
//
// What bounds it on an H100: instruction issue.  Each (pixel, row)
// fragment needs ~30 FP32 operations and one expf, while a row's 11
// attributes (44 bytes) are shared by the tile's 256 pixels: ~175
// operations per byte, far above the card's ~20 FP32 operations per byte
// of HBM bandwidth.  Built without FMA contraction, every operation is its
// own instruction.  The first design (one thread per pixel, rows staged as
// 11 float arrays) issued ~50 instructions per fragment, 11 of them scalar
// shared-memory loads, and blended every row against every pixel.  This
// design:
//
//   * Rows are staged once per window as 16-byte records (cx cy A B |
//     C op rx ry | r g b -), so a thread reads a row with three broadcast
//     128-bit loads: the first two for the fragment math, the colour
//     record only when compositing (so the colours are not held in
//     registers across the math).  The global loads stay coalesced (one
//     table column per thread and attribute).
//   * Threads own 2 pixels (128-thread CTAs, 4 warps), as in the backward
//     (tile_raster_bwd.cu): warp w owns the 16x4-pixel band of tile rows
//     4w .. 4w+3, lane l holds pixels p = 64w + l and p + 32 (tile rows
//     4w + l/16 and 4w + 2 + l/16), which share the column px.  A warp's
//     band is 64 pixels at every size: all 8 rows of an 8x8 tile (one
//     warp, 32 threads) or an 8x8 square of a 32x32 tile (16 warps, 512
//     threads, 16 cull bits per row).  So dx,
//     A dx dx, B dx and the |dx| <= rx test are computed once per row for
//     both (power is -0.5 (A dx dx + C dy dy) - B dx dy, evaluated left to
//     right, so (A dx) dx and B dx are its own subterms), and one staged
//     row feeds 2 fragments.  Each pixel's operations and their order are
//     unchanged, so its bits are.
//   * Exact warp cull.  When a window is staged, each row's bitmask of the
//     4 bands its 3-sigma rect reaches is computed once with the kernel's
//     own test, fabsf(px - cx) <= rx and fabsf(py - cy) <= ry, at every
//     column centre of the tile and every row centre of the band (a band
//     is the product of its 16 columns and 4 rows, so the rect reaches a
//     pixel of it iff it reaches one of its columns and one of its rows).
//     A warp walks only the rows that reach its band (a ballot per 32
//     rows, then a warp-uniform loop).  Exact: outside the rect alpha == 0
//     in every mode (in_rect gates keep, and billboard alpha is in_rect),
//     so T * (1 - 0) == T bit for bit; the skipped colour adds are
//     acc + (+0 * T) * c with T in [0, 1] and c finite, i.e. adding +0 or
//     -0 to an accumulator that starts at +0 and so is never -0 (x + y
//     rounds an exact zero to +0), which leaves it unchanged.  In
//     gaussian-ball mode the weight is (0 * T) * gauss with gauss =
//     exp(power) finite: power is minus half a positive-definite quadratic
//     form (the conic of a low-pass-filtered covariance), so it is <= 0
//     up to rounding and exp(power) <= 1 + O(ulp); the product is +0.
//     ops/kernels/tile_raster_fwd.py warp_cull_plain is the plain mirror,
//     shared with the backward.
//   * A thread's two fragments of a row are independent, so their two expf
//     overlap.  Taking rows two at a time (four fragments in flight)
//     measured no faster (fwd_ablation.py), so a warp takes one at a time.
//
// Resources (sm_90a), 16x16: 12,544 bytes of static shared memory per CTA
// (the window as 256 x 48-byte rows, 12 KB, and the 256 cull masks);
// launch bounds of 8 CTAs per SM (32 warps, at most 64 registers, no
// spills).  8x8 and 32x32 ask for the same 32 warps per SM (32 and 2
// CTAs).  gsv_tile_raster_fwd_occupancy reports the registers, spills,
// shared memory and CTAs per SM as built.  B2 adds two coalesced 128-byte
// checkpoint stores per warp and window and one int per tile.
//
// Other tile sizes (fwd_ablation.py --tiles, PERF.md):
//   * 32x32, 16 warps.  A 32x2 strip of tile rows is reached by the rect
//     of every small splat that crosses its two rows, so the bands are 8x8
//     squares (pixel_of: lane l of warp w holds column l % 8 of square w,
//     rows l / 8 and l / 8 + 4, still one column per thread), culled by
//     their 8 columns and 8 rows as the backward culls them: on the 1M
//     frame the cull keeps 0.24 of the blended (row, band) pairs against
//     0.35 for strips.  The cull is exact with any band shape and each
//     pixel's operations and row order are unchanged, so every output is
//     the strips' bit for bit; only the stores and checkpoints are indexed
//     by the square pixel.  12,800 bytes (16-bit masks), 2 CTAs per SM.
//   * 8x8, one warp per CTA.  Shared memory bounds the CTAs per SM, and a
//     one-warp CTA waits on its own latencies: the 12,544-byte window held
//     17 per SM.  So one 128-row block of the window is staged at a time
//     (6,272 bytes, 32 CTAs per SM, the SM's limit), as the backward does
//     at 8x8; a block without rows of the tile is skipped.  The early stop
//     is still tested once per 256-row window, before it, and B2 writes
//     each block's exiting T as before: the results are the window's bit
//     for bit.
//
// Built with -fmad=false and without --use_fast_math (see
// ops/kernels/build.py): the discrete thresholds then see exactly the
// values the plain PyTorch version computes, and the backward (B3, B5)
// recomputes B2's alpha and T bit for bit.
//
// Surfels (2D Gaussian splatting): tile_raster_fwd_surfel.cu includes this
// file with GSV_FWD_SURFEL defined, which gives the same entry points (B1s,
// B2s, B4s) the instantiations of MODE kSurfel in place of the four 3DGS
// modes, in their own library: a 3DGS render never builds or loads them,
// and nothing here changes for it.  A surfel row is 15 attributes (cx cy,
// the rows Tu Tv Tw of its homography, rgb, opacity), staged as four
// records (Tu cx | Tv cy | Tw op | r g b -); its fragment is the ray-disk
// intersection of ops/kernels/tile_raster_fwd.py surfel_fragments (p = k
// x l with k = px Tw - Tu, computed once per row for the thread's column,
// and l = py Tw - Tv; rho = min(u^2 + v^2, the sigma = sqrt(2)/2 low-pass
// around (cx, cy)); the near test on the intersection's depth).  A
// surfel's fragment has no rect; its warp cull (surfel_band_mask) takes
// the bounding rect of the pixels where alpha can reach alpha_min, widened
// for rounding, so it is exact as the 3DGS cull is, and the plain version
// blends every row.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPix = 2;                   // pixels per thread, one column
constexpr int kChunk = 256;               // rows per window
constexpr int kAlign = 128;               // window alignment
constexpr int kAttrs = 11;                // table rows 0..10 (cx .. ry)
constexpr unsigned kFull = 0xffffffffu;

// The geometry of a TILE x TILE tile.
template <int TILE>
struct Geo {
  static constexpr int kTile = TILE;
  static constexpr int kPixels = kTile * kTile;
  static constexpr int kThreads = kPixels / kPix;  // 32, 128, 512
  static constexpr int kWarps = kThreads / 32;     // one band each
  static constexpr int kBandRows = kTile / kWarps;  // 8, 4, 2 rows
  static constexpr int kMinCtas = 32 / kWarps;     // 32 warps per SM
  // a warp's band: kBandRows whole tile rows, or at 32x32 an 8x8 square
  // (pixel_of), which the rects of small splats reach far less often
  // than a 32x2 strip (the backward's bands there too)
  static constexpr bool kSquare = TILE == 32;
  // rows staged at once: a 256-row window, or at 8x8 one 128-row block,
  // so that 32 one-warp CTAs fit an SM's shared memory, not 17
  static constexpr int kStageRows = TILE == 8 ? kAlign : kChunk;
  // staging passes over kStageRows rows (a thread stages rows tid,
  // tid + kThreads, ...; at 32x32 half the threads stage none)
  static constexpr int kStage = (kStageRows + kThreads - 1) / kThreads;
  // one cull bit per band (warp)
  using Mask = typename std::conditional<(kWarps <= 8), unsigned char,
                                         unsigned short>::type;
  static_assert(kWarps * 32 * kPix == kPixels && kBandRows * kWarps == kTile,
                "a warp's pixels must be whole tile rows");
  static_assert(kWarps <= 16, "16 bands at most");
  static_assert(!kSquare || (kTile / 8) * (kTile / 8) == kWarps,
                "one 8x8 square per warp");
  static_assert(kStageRows == kChunk || kStage * kThreads == kStageRows,
                "a staged block takes whole passes");
};

// table row indices (ops/binning.py column map)
constexpr int kCx = 0, kCy = 1, kA = 2, kB = 3, kC = 4;
constexpr int kR = 5, kG = 6, kBch = 7, kOpacity = 8, kRx = 9, kRy = 10;

enum Mode { kGauss = 0, kBillboard = 1, kFlatBall = 2, kGaussBall = 3,
            kSurfel = 4 };

// 16-byte records per staged row: 3 (shape, shape, colour), 4 for surfels
template <int MODE>
struct Recs {
  static constexpr int n = MODE == kSurfel ? 4 : 3;
};

// surfel rows (ops/binning.py's surfel column map) and the near test
constexpr int kTu = 2, kTv = 9, kTw = 12, kSurfelAttrs = 15;
constexpr float kSurfelNear = 0.2f;

template <int TILE, int RECS = 3>
struct Smem {
  using G = Geo<TILE>;
  float4 rows[G::kStageRows * RECS];     // row j: records RECS j ..
  typename G::Mask mask[G::kStageRows];  // bands each row's rect reaches
};

struct Params {
  float alpha_clamp, alpha_min, ball_threshold;
};

// A staged row's fragment attributes, read as two 16-byte broadcasts ...
struct Shape {
  float cx, cy, a, b, c, op, rx, ry;
  __device__ __forceinline__ explicit Shape(const float4* s) {
    const float4 q0 = s[0], q1 = s[1];
    cx = q0.x; cy = q0.y; a = q0.z; b = q0.w;
    c = q1.x; op = q1.y; rx = q1.z; ry = q1.w;
  }
};

// ... and its colour, one more.
struct Colour {
  float r, g, b;
  __device__ __forceinline__ explicit Colour(const float4* s) {
    const float4 q = s[2];
    r = q.x; g = q.y; b = q.z;
  }
};

// Pixel i (row-major in the tile) of the thread (warp, lane): warp w holds
// the band of tile rows kBandRows w .., lane l column l % TILE; at 32x32
// the 8x8 square w (squares row-major), lane l column l % 8 of it, rows
// l / 8 and l / 8 + 4 (the backward's square_pixel).
template <int TILE>
__device__ __forceinline__ int pixel_of(int warp, int lane, int i) {
  if constexpr (Geo<TILE>::kSquare) {
    constexpr int kSq = TILE / 8;  // squares per tile row
    return ((warp / kSq) * 8 + i * 4 + lane / 8) * TILE + (warp % kSq) * 8 +
           lane % 8;
  }
  return warp * 32 * kPix + i * 32 + lane;
}

// Bands (bit w: the pixels of warp w) that a row's 3-sigma rect reaches,
// by the kernel's own rect test at the pixel centres.
template <int TILE>
__device__ __forceinline__ unsigned band_mask(float cx, float cy, float rx,
                                              float ry, float tx, float ty) {
  constexpr int kTile = TILE, kWarps = Geo<TILE>::kWarps;
  constexpr int kBandRows = Geo<TILE>::kBandRows;
  if constexpr (Geo<TILE>::kSquare) {
    // square w is the product of column group w % kSq and row group w / kSq
    constexpr int kSq = kTile / 8;
    unsigned xg = 0, yg = 0;  // bit g: the rect reaches group g
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const float px = tx * kTile + static_cast<float>(k) + 0.5f;
      const float py = ty * kTile + static_cast<float>(k) + 0.5f;
      xg |= fabsf(px - cx) <= rx ? 1u << (k / 8) : 0u;
      yg |= fabsf(py - cy) <= ry ? 1u << (k / 8) : 0u;
    }
    unsigned m = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m |= ((xg >> (w % kSq)) & (yg >> (w / kSq)) & 1u) << w;
    }
    return m;
  }
  bool x_hit = false;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const float px = tx * kTile + static_cast<float>(k) + 0.5f;
    x_hit |= fabsf(px - cx) <= rx;
  }
  unsigned m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    bool y_hit = false;
#pragma unroll
    for (int y = 0; y < kBandRows; ++y) {
      const float py =
          ty * kTile + static_cast<float>(w * kBandRows + y) + 0.5f;
      y_hit |= fabsf(py - cy) <= ry;
    }
    m |= (x_hit && y_hit) ? 1u << w : 0u;
  }
  return m;
}

// Bands whose pixel centres a surfel row can take to alpha_min: alpha >=
// alpha_min needs rho <= thr = 2 ln(op / alpha_min), which holds only in
// the low-pass's disk |p - (cx, cy)|^2 <= thr / 2 and in the disk's own
// ellipse rho3d <= thr, whose centre and half-extents come from its dual
// conic as the bound's do (projection_surfel.cu, cutoff^2 = thr).  The
// bands that the bounding rect of both reaches, by band_mask, the rect
// widened by kSurfelRoom of its extent and coordinates plus 0.1 px for
// rounding; none where op < alpha_min, every band where the ellipse does
// not exist (the disk's rho3d = thr circle reaches its plane's horizon).
constexpr float kSurfelRoom = 1e-3f;

template <int TILE>
__device__ __forceinline__ unsigned surfel_band_mask(const float* v,
                                                     float log_alpha_min,
                                                     float tx, float ty) {
  constexpr unsigned kAll = (1u << Geo<TILE>::kWarps) - 1u;
  const float op = v[kOpacity];
  if (!(op > 0.0f)) return 0u;
  const float thr = 2.0f * (logf(op) - log_alpha_min);
  if (thr < 0.0f) return 0u;
  const float* tu = v + kTu;
  const float* tv = v + kTv;
  const float* tw = v + kTw;
  const float d = thr * (tw[0] * tw[0] + tw[1] * tw[1]) - tw[2] * tw[2];
  if (!(d < 0.0f)) return kAll;
  // sum_k t_k p_k q_k / d with t = (thr, thr, -1)
  auto tdot = [&](const float* p, const float* q) {
    return (thr * (p[0] * q[0] + p[1] * q[1]) - p[2] * q[2]) / d;
  };
  const float mx = tdot(tu, tw), my = tdot(tv, tw);
  const float ex = sqrtf(fmaxf(mx * mx - tdot(tu, tu), 0.0f));
  const float ey = sqrtf(fmaxf(my * my - tdot(tv, tv), 0.0f));
  const float r2 = sqrtf(0.5f * thr);
  const float x0 = fminf(mx - ex, v[kCx] - r2);
  const float x1 = fmaxf(mx + ex, v[kCx] + r2);
  const float y0 = fminf(my - ey, v[kCy] - r2);
  const float y1 = fmaxf(my + ey, v[kCy] + r2);
  if (!(x1 - x0 < 1e30f && y1 - y0 < 1e30f)) return kAll;
  const float rx = 0.5f * (x1 - x0) +
                   kSurfelRoom * (x1 - x0 + fabsf(x0) + fabsf(x1)) + 0.1f;
  const float ry = 0.5f * (y1 - y0) +
                   kSurfelRoom * (y1 - y0 + fabsf(y0) + fabsf(y1)) + 0.1f;
  return band_mask<TILE>(0.5f * (x0 + x1), 0.5f * (y0 + y1), rx, ry, tx, ty);
}

// Stage the kStageRows table columns from col0 into shared memory (row j
// of the stage is column col0 + j; a thread stages rows tid, tid +
// kThreads, ...; at 32x32 half the threads stage none), each row with its
// band mask; columns outside the tile's [start, end) get mask 0.  A surfel
// row's mask is surfel_band_mask's.
template <int TILE, int MODE = kGauss>
__device__ __forceinline__ void stage_rows(Smem<TILE, Recs<MODE>::n>& sm,
                                           const float* __restrict__ table,
                                           int64_t dpad, int col0, int start,
                                           int end, int tid, float tx,
                                           float ty,
                                           float log_alpha_min = 0.0f) {
  using G = Geo<TILE>;
#pragma unroll
  for (int h = 0; h < G::kStage; ++h) {
    const int j = tid + h * G::kThreads;
    if constexpr (G::kThreads > G::kStageRows) {
      if (j >= G::kStageRows) break;
    }
    const int col = col0 + j;
    unsigned m = 0;
    if (col >= start && col < end) {
      if constexpr (MODE == kSurfel) {
        float v[kSurfelAttrs];
#pragma unroll
        for (int a = 0; a < kSurfelAttrs; ++a) {
          v[a] = table[static_cast<int64_t>(a) * dpad + col];
        }
        sm.rows[j * 4 + 0] = make_float4(v[kTu], v[kTu + 1], v[kTu + 2],
                                         v[kCx]);
        sm.rows[j * 4 + 1] = make_float4(v[kTv], v[kTv + 1], v[kTv + 2],
                                         v[kCy]);
        sm.rows[j * 4 + 2] = make_float4(v[kTw], v[kTw + 1], v[kTw + 2],
                                         v[kOpacity]);
        sm.rows[j * 4 + 3] = make_float4(v[kR], v[kG], v[kBch], 0.0f);
        m = surfel_band_mask<TILE>(v, log_alpha_min, tx, ty);
      } else {
        float v[kAttrs];
#pragma unroll
        for (int a = 0; a < kAttrs; ++a) {
          v[a] = table[static_cast<int64_t>(a) * dpad + col];
        }
        sm.rows[j * 3 + 0] = make_float4(v[kCx], v[kCy], v[kA], v[kB]);
        sm.rows[j * 3 + 1] = make_float4(v[kC], v[kOpacity], v[kRx], v[kRy]);
        sm.rows[j * 3 + 2] = make_float4(v[kR], v[kG], v[kBch], 0.0f);
        m = band_mask<TILE>(v[kCx], v[kCy], v[kRx], v[kRy], tx, ty);
      }
    }
    sm.mask[j] = static_cast<typename G::Mask>(m);
  }
}

// A surfel row's fragment alphas at the thread's pixels (px, py[i]), in
// surfel_fragments' expressions and order; k = px Tw - Tu is the
// column's, computed once.
__device__ __forceinline__ void surfel_alpha(const float4* row, float px,
                                             const float (&py)[kPix],
                                             const Params& prm,
                                             float (&alpha)[kPix]) {
  const float4 qu = row[0], qv = row[1], qw = row[2];
  const float k0 = px * qw.x - qu.x;
  const float k1 = px * qw.y - qu.y;
  const float k2 = px * qw.z - qu.z;
  const float dx = qu.w - px;
  const float dxdx = dx * dx;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const float l0 = py[i] * qw.x - qv.x;
    const float l1 = py[i] * qw.y - qv.y;
    const float l2 = py[i] * qw.z - qv.z;
    const float p1 = k1 * l2 - k2 * l1;
    const float p2 = k2 * l0 - k0 * l2;
    const float p3 = k0 * l1 - k1 * l0;
    const bool hit = p3 != 0.0f;
    const float p3s = hit ? p3 : 1.0f;
    const float u = p1 / p3s;
    const float v = p2 / p3s;
    const float rho3d = u * u + v * v;
    const float dy = qv.w - py[i];
    const float rho2d = 2.0f * (dxdx + dy * dy);
    const bool on_disk = rho3d <= rho2d;
    const float rho = on_disk ? rho3d : rho2d;
    const float depth = on_disk ? u * qw.x + v * qw.y + qw.z : qw.z;
    const float power = -0.5f * rho;
    float a = fminf(prm.alpha_clamp, qw.w * expf(power));
    const bool keep = hit && depth >= kSurfelNear && power <= 0.0f &&
                      a >= prm.alpha_min;
    alpha[i] = keep ? a : 0.0f;
  }
}

// Composite one staged surfel row into the thread's pixels.
__device__ __forceinline__ void blend_row_surfel(const float4* row, float px,
                                                 const float (&py)[kPix],
                                                 const Params& prm,
                                                 float (&T)[kPix],
                                                 float (&acc)[kPix][3]) {
  float alpha[kPix];
  surfel_alpha(row, px, py, prm, alpha);
  const float4 c = row[3];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const float weight = alpha[i] * T[i];
    acc[i][0] += weight * c.x;
    acc[i][1] += weight * c.y;
    acc[i][2] += weight * c.z;
    T[i] = T[i] * (1.0f - alpha[i]);
  }
}

// Composite one staged row into the thread's pixels (px, py[i]).  Per
// pixel the expressions and their order are _chunk_blend's; the column's
// terms are computed once.
template <int MODE>
__device__ __forceinline__ void blend_row(const float4* row, float px,
                                          const float (&py)[kPix],
                                          const Params& prm, float (&T)[kPix],
                                          float (&acc)[kPix][3]) {
  const Shape q(row);
  const float dx = px - q.cx;
  const float adxdx = q.a * dx * dx;
  const float bdx = q.b * dx;
  const bool x_in = fabsf(dx) <= q.rx;
  float alpha[kPix], gauss[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const float dy = py[i] - q.cy;
    const float power = -0.5f * (adxdx + q.c * dy * dy) - bdx * dy;
    const bool in_rect = x_in && fabsf(dy) <= q.ry;
    if (MODE == kBillboard) {
      alpha[i] = in_rect ? 1.0f : 0.0f;
      gauss[i] = 1.0f;
    } else {
      const float g = expf(power);
      float a = fminf(prm.alpha_clamp, q.op * g);
      const bool keep = in_rect && power <= 0.0f && a >= prm.alpha_min;
      a = keep ? a : 0.0f;
      if (MODE == kFlatBall || MODE == kGaussBall) {
        a = (keep && a > prm.ball_threshold) ? 1.0f : 0.0f;
      }
      alpha[i] = a;
      gauss[i] = g;
    }
  }
  const Colour c(row);
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    float weight = alpha[i] * T[i];
    if (MODE == kGaussBall) weight = weight * gauss[i];
    acc[i][0] += weight * c.r;
    acc[i][1] += weight * c.g;
    acc[i][2] += weight * c.b;
    T[i] = T[i] * (1.0f - alpha[i]);
  }
}

// Composite the staged rows [j_lo, j_hi) that reach this warp's band, in
// order (the loop is warp-uniform).
template <int TILE, int MODE>
__device__ __forceinline__ void blend_rows(const Smem<TILE, Recs<MODE>::n>& sm,
                                           int j_lo,
                                           int j_hi, int warp, int lane,
                                           float px, const float (&py)[kPix],
                                           const Params& prm, float (&T)[kPix],
                                           float (&acc)[kPix][3]) {
  for (int s0 = j_lo; s0 < j_hi; s0 += 32) {
    const int n = min(j_hi - s0, 32);
    unsigned m = __ballot_sync(
        kFull, lane < n && ((sm.mask[s0 + lane] >> warp) & 1u));
    while (m) {
      const int j = s0 + __ffs(m) - 1;
      m &= m - 1;
      if constexpr (MODE == kSurfel) {
        blend_row_surfel(&sm.rows[j * 4], px, py, prm, T, acc);
      } else {
        blend_row<MODE>(&sm.rows[j * 3], px, py, prm, T, acc);
      }
    }
  }
}

// TRAIN = false is kernel B1, TRAIN = true kernel B2 (nproc and ckpt are
// written only then); SEEDED adds B4's entering transmittance t_init.
template <int TILE, int MODE, bool TRAIN, bool SEEDED>
__global__ void __launch_bounds__(Geo<TILE>::kThreads, Geo<TILE>::kMinCtas)
    tile_raster_fwd_kernel(
    const float* __restrict__ table, int64_t dpad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    int row_offset, int tiles_x, int row_stride, float alpha_clamp,
    float alpha_min, float ball_threshold, float early_stop,
    const float* __restrict__ t_init, float* __restrict__ out_rgb,
    float* __restrict__ out_trans, int* __restrict__ out_nproc,
    float* __restrict__ ckpt) {
  using G = Geo<TILE>;
  constexpr int kTile = G::kTile, kPixels = G::kPixels;
  __shared__ Smem<TILE, Recs<MODE>::n> sm;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = starts[t];
  const int end = start + counts[t];
  const int base = (start / kAlign) * kAlign;
  const int num_chunks = end > start ? (end - base + kChunk - 1) / kChunk : 0;
  const Params prm{alpha_clamp, alpha_min, ball_threshold};
  // the surfel cull's ln(alpha_min); 3DGS stages no surfel rows
  const float log_amin = MODE == kSurfel ? logf(alpha_min) : 0.0f;

  const float tx = static_cast<float>(t % tiles_x);
  const float ty = static_cast<float>((t / tiles_x) * row_stride + row_offset);
  // the thread's pixels share one column
  const float px =
      tx * kTile + static_cast<float>(pixel_of<TILE>(warp, lane, 0) % kTile) +
      0.5f;
  float py[kPix], T[kPix], acc[kPix][3];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = pixel_of<TILE>(warp, lane, i);
    py[i] = ty * kTile + static_cast<float>(p / kTile) + 0.5f;
    T[i] = SEEDED ? t_init[static_cast<int64_t>(t) * kPixels + p] : 1.0f;
    acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;
  }
  // B2: the thread's pixels' T at column c of the checkpoint buffer,
  // ckpt[p / 128][c + p % 128] (one 128-byte store per warp and pixel)
  auto put_ckpt = [&](int c) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = pixel_of<TILE>(warp, lane, i);
      ckpt[static_cast<int64_t>(p / kAlign) * dpad + c + p % kAlign] = T[i];
    }
  };

  int ci = 0;
  for (; ci < num_chunks; ++ci) {
    bool live = false;
#pragma unroll
    for (int i = 0; i < kPix; ++i) live |= T[i] > early_stop;
    // tile-wide stop; also the barrier before the window is overwritten
    if (!__syncthreads_or(live)) break;
    const int w0 = base + ci * kChunk;
    if constexpr (G::kStageRows == kChunk) {
      stage_rows<TILE, MODE>(sm, table, dpad, w0, start, end, tid, tx, ty,
                             log_amin);
      __syncthreads();
      const int lo = max(start - w0, 0);
      const int hi = min(end - w0, kChunk);
      if (!TRAIN) {
        blend_rows<TILE, MODE>(sm, lo, hi, warp, lane, px, py, prm, T, acc);
      } else {
        // the window's two 128-row blocks; each block's exiting T is the
        // next block's entering checkpoint, written only where that block
        // holds live rows of this tile (see the header on write races)
        const int mid = min(max(lo, kAlign), hi);
        blend_rows<TILE, MODE>(sm, lo, mid, warp, lane, px, py, prm, T,
                               acc);
        if (w0 + kAlign < end) put_ckpt(w0 + kAlign);
        blend_rows<TILE, MODE>(sm, mid, hi, warp, lane, px, py, prm, T,
                               acc);
        if (w0 + kChunk < end) put_ckpt(w0 + kChunk);
      }
    } else {
      // 8x8, one warp: the window's two 128-row blocks staged and blended
      // one at a time; a block without live rows of the tile is neither
      // staged nor walked.  The rows, their order and the checkpoints are
      // the window's.
      const int lo = max(start - w0, 0);
      const int hi = min(end - w0, kChunk);
#pragma unroll
      for (int b0 = 0; b0 < kChunk; b0 += kAlign) {
        const int jlo = max(lo, b0), jhi = min(hi, b0 + kAlign);
        if (jlo < jhi) {
          __syncwarp();  // the warp is done with the previous block
          stage_rows<TILE, MODE>(sm, table, dpad, w0 + b0, start, end, tid,
                                 tx, ty, log_amin);
          __syncwarp();
          blend_rows<TILE, MODE>(sm, jlo - b0, jhi - b0, warp, lane, px, py,
                                 prm, T, acc);
        }
        // the block's exiting T, as above
        if (TRAIN && w0 + b0 + kAlign < end) put_ckpt(w0 + b0 + kAlign);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int64_t o =
        static_cast<int64_t>(t) * kPixels + pixel_of<TILE>(warp, lane, i);
    out_rgb[o * 3 + 0] = acc[i][0];
    out_rgb[o * 3 + 1] = acc[i][1];
    out_rgb[o * 3 + 2] = acc[i][2];
    out_trans[o] = T[i];
  }
  if (TRAIN && tid == 0) out_nproc[t] = ci;
}

// Call f(kernel, threads) with the kernel instantiation of this mode (the
// surfel library: kSurfel for the SH and DEPTH modes' code 0).
template <int TILE, bool TRAIN, bool SEEDED, typename F>
int by_mode(int mode, F&& f) {
  constexpr int n = Geo<TILE>::kThreads;
#ifdef GSV_FWD_SURFEL
  if (mode == kGauss) {
    return f(tile_raster_fwd_kernel<TILE, kSurfel, TRAIN, SEEDED>, n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
#else
  switch (mode) {
    case kGauss:
      return f(tile_raster_fwd_kernel<TILE, kGauss, TRAIN, SEEDED>, n);
    case kBillboard:
      return f(tile_raster_fwd_kernel<TILE, kBillboard, TRAIN, SEEDED>, n);
    case kFlatBall:
      return f(tile_raster_fwd_kernel<TILE, kFlatBall, TRAIN, SEEDED>, n);
    case kGaussBall:
      return f(tile_raster_fwd_kernel<TILE, kGaussBall, TRAIN, SEEDED>, n);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}

// ... and of this tile size: 8, 16 or 32, but 16 for B4 train (the fused
// path's).
template <bool TRAIN, bool SEEDED, typename F>
int by_tile(int tile, int mode, F&& f) {
  if (tile == 16) return by_mode<16, TRAIN, SEEDED>(mode, f);
  if constexpr (!(TRAIN && SEEDED)) {
    if (tile == 8) return by_mode<8, TRAIN, SEEDED>(mode, f);
    if (tile == 32) return by_mode<32, TRAIN, SEEDED>(mode, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool TRAIN, bool SEEDED>
int launch(const float* table, long long dpad, const int* starts,
           const int* counts, int num_tiles, int row_offset, int tiles_x,
           int row_stride, int tile, int mode, float alpha_clamp,
           float alpha_min, float ball_threshold, float early_stop,
           const float* t_init, float* out_rgb, float* out_trans,
           int* out_nproc, float* ckpt, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tile<TRAIN, SEEDED>(tile, mode, [&](auto kernel, int threads) {
    kernel<<<num_tiles, threads, 0, s>>>(
        table, dpad, starts, counts, row_offset, tiles_x, row_stride,
        alpha_clamp, alpha_min, ball_threshold, early_stop, t_init, out_rgb,
        out_trans, out_nproc, ckpt);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" int gsv_tile_raster_fwd(
    const float* table, long long dpad, const int* starts, const int* counts,
    int num_tiles, int row_offset, int tiles_x, int row_stride, int tile,
    int mode,
    float alpha_clamp, float alpha_min, float ball_threshold,
    float early_stop, float* out_rgb, float* out_trans, void* stream) {
  return launch<false, false>(table, dpad, starts, counts, num_tiles,
                              row_offset, tiles_x, row_stride, tile, mode,
                              alpha_clamp, alpha_min, ball_threshold,
                              early_stop, nullptr, out_rgb, out_trans,
                              nullptr, nullptr, stream);
}

extern "C" int gsv_tile_raster_fwd_train(
    const float* table, long long dpad, const int* starts, const int* counts,
    int num_tiles, int row_offset, int tiles_x, int row_stride, int tile,
    int mode,
    float alpha_clamp, float alpha_min, float ball_threshold,
    float early_stop, float* out_rgb, float* out_trans, int* out_nproc,
    float* ckpt, void* stream) {
  return launch<true, false>(table, dpad, starts, counts, num_tiles,
                             row_offset, tiles_x, row_stride, tile, mode,
                             alpha_clamp, alpha_min, ball_threshold,
                             early_stop, nullptr, out_rgb, out_trans,
                             out_nproc, ckpt, stream);
}

extern "C" int gsv_tile_raster_fwd_seeded(
    const float* table, long long dpad, const int* starts, const int* counts,
    int num_tiles, int row_offset, int tiles_x, int row_stride, int tile,
    int mode,
    float alpha_clamp, float alpha_min, float ball_threshold,
    float early_stop, const float* t_init, float* out_rgb, float* out_trans,
    void* stream) {
  return launch<false, true>(table, dpad, starts, counts, num_tiles,
                             row_offset, tiles_x, row_stride, tile, mode,
                             alpha_clamp, alpha_min, ball_threshold,
                             early_stop, t_init, out_rgb, out_trans, nullptr,
                             nullptr, stream);
}

extern "C" int gsv_tile_raster_fwd_seeded_train(
    const float* table, long long dpad, const int* starts, const int* counts,
    int num_tiles, int row_offset, int tiles_x, int row_stride, int tile,
    int mode,
    float alpha_clamp, float alpha_min, float ball_threshold,
    float early_stop, const float* t_init, float* out_rgb, float* out_trans,
    int* out_nproc, float* ckpt, void* stream) {
  return launch<true, true>(table, dpad, starts, counts, num_tiles,
                            row_offset, tiles_x, row_stride, tile, mode,
                            alpha_clamp, alpha_min, ball_threshold,
                            early_stop, t_init, out_rgb, out_trans, out_nproc,
                            ckpt, stream);
}

// Resources of one instantiation as built: registers per thread, local
// (spill) bytes per thread, shared memory per CTA, and the CTAs one SM
// holds at once.
extern "C" int gsv_tile_raster_fwd_occupancy(int tile, int mode, int train,
                                             int seeded, int* regs,
                                             int* local_bytes,
                                             int* smem_bytes,
                                             int* ctas_per_sm) {
  auto query = [&](auto kernel, int threads) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                        threads, 0);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
    return 0;
  };
  if (train) {
    return seeded ? by_tile<true, true>(tile, mode, query)
                  : by_tile<true, false>(tile, mode, query);
  }
  return seeded ? by_tile<false, true>(tile, mode, query)
                : by_tile<false, false>(tile, mode, query);
}

extern "C" const char* gsv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
