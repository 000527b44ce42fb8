// Tile blend forward: front-to-back alpha blending of the depth-sorted
// splat rows of each tile.  One kernel template, four entry points:
//
//   gsv_tile_raster_fwd               kernel B1, the inference blend;
//   gsv_tile_raster_fwd_train         kernel B2, B1 plus the backward's
//                                     residuals;
//   gsv_tile_raster_fwd_seeded        kernel B4, the fused path's residual
//   gsv_tile_raster_fwd_seeded_train  pass (inference and train variants).
//
// Tile sizes: the inference variants (B1, B4) take 8x8, 16x16 and 32x32
// tiles, as the TPU kernel does; the training variants (B2, B4 train) take
// 16x16 only, the TPU train kernel's limit (its checkpoint is laid out for
// 256 pixels, ops/pallas/tile_raster_fwd.py:334), which the backward (B3,
// B5) shares.  The text below describes the 16x16 tile; Geo<TILE> gives
// the other sizes' geometry.
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
//   ckpt      (2, dpad): pixel p's transmittance ENTERING the 128-row block
//             that starts at column c is ckpt[p / 128][c + p % 128].  Each
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
//     warp, 32 threads) or 2 rows of a 32x32 tile (16 warps, 512 threads,
//     16 cull bits per row).  So dx,
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
// spills).  8x8 and 32x32 ask for the same 32 warps per SM (32 and 2 CTAs)
// and keep the window; at 8x8 shared memory holds 17 one-warp CTAs per SM.
// 32x32's masks are 16-bit (12,800 bytes).
// gsv_tile_raster_fwd_occupancy reports the registers, spills, shared
// memory and CTAs per SM as built.  B2 adds two coalesced 128-byte
// checkpoint stores per warp and window and one int per tile.
//
// Built with -fmad=false and without --use_fast_math (see
// ops/kernels/build.py): the discrete thresholds then see exactly the
// values the plain PyTorch version computes, and the backward (B3, B5)
// recomputes B2's alpha and T bit for bit.

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
  static constexpr int kWarps = kThreads / 32;     // one band of rows each
  static constexpr int kBandRows = kTile / kWarps;  // 8, 4, 2 rows
  static constexpr int kMinCtas = 32 / kWarps;     // 32 warps per SM
  // staging passes over a window's kChunk rows (a thread stages rows tid,
  // tid + kThreads, ...; at 32x32 half the threads stage none)
  static constexpr int kStage = (kChunk + kThreads - 1) / kThreads;
  // one cull bit per band (warp)
  using Mask = typename std::conditional<(kWarps <= 8), unsigned char,
                                         unsigned short>::type;
  static_assert(kWarps * 32 * kPix == kPixels && kBandRows * kWarps == kTile,
                "a warp's pixels must be whole tile rows");
  static_assert(kWarps <= 16, "16 bands at most");
};

// table row indices (ops/binning.py column map)
constexpr int kCx = 0, kCy = 1, kA = 2, kB = 3, kC = 4;
constexpr int kR = 5, kG = 6, kBch = 7, kOpacity = 8, kRx = 9, kRy = 10;

enum Mode { kGauss = 0, kBillboard = 1, kFlatBall = 2, kGaussBall = 3 };

template <int TILE>
struct Smem {
  float4 rows[kChunk * 3];                 // row j: records 3j (shape) ..
  typename Geo<TILE>::Mask mask[kChunk];   // bands each row's rect reaches
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
// the band of tile rows kBandRows w .., lane l column l % TILE.
__device__ __forceinline__ int pixel_of(int warp, int lane, int i) {
  return warp * 32 * kPix + i * 32 + lane;
}

// Bands (bit w: the pixels of warp w) that a row's 3-sigma rect reaches,
// by the kernel's own rect test at the pixel centres.
template <int TILE>
__device__ __forceinline__ unsigned band_mask(float cx, float cy, float rx,
                                              float ry, float tx, float ty) {
  constexpr int kTile = TILE, kWarps = Geo<TILE>::kWarps;
  constexpr int kBandRows = Geo<TILE>::kBandRows;
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
__device__ __forceinline__ void blend_rows(const Smem<TILE>& sm, int j_lo,
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
      blend_row<MODE>(&sm.rows[j * 3], px, py, prm, T, acc);
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
  static_assert(!TRAIN || TILE == 16, "the checkpoint layout is 16x16's");
  __shared__ Smem<TILE> sm;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = starts[t];
  const int end = start + counts[t];
  const int base = (start / kAlign) * kAlign;
  const int num_chunks = end > start ? (end - base + kChunk - 1) / kChunk : 0;
  const Params prm{alpha_clamp, alpha_min, ball_threshold};

  const float tx = static_cast<float>(t % tiles_x);
  const float ty = static_cast<float>((t / tiles_x) * row_stride + row_offset);
  // the thread's pixels share one column
  const float px =
      tx * kTile + static_cast<float>(pixel_of(warp, lane, 0) % kTile) + 0.5f;
  float py[kPix], T[kPix], acc[kPix][3];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = pixel_of(warp, lane, i);
    py[i] = ty * kTile + static_cast<float>(p / kTile) + 0.5f;
    T[i] = SEEDED ? t_init[static_cast<int64_t>(t) * kPixels + p] : 1.0f;
    acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;
  }
  // B2: the thread's pixels' T at column c of the checkpoint buffer,
  // ckpt[p / 128][c + p % 128] (one 128-byte store per warp and pixel)
  auto put_ckpt = [&](int c) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = pixel_of(warp, lane, i);
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
#pragma unroll
    for (int h = 0; h < G::kStage; ++h) {
      const int j = tid + h * G::kThreads;
      if constexpr (G::kThreads > kChunk) {
        if (j >= kChunk) break;
      }
      const int col = w0 + j;
      unsigned m = 0;
      if (col >= start && col < end) {
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
      sm.mask[j] = static_cast<typename G::Mask>(m);
    }
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
      blend_rows<TILE, MODE>(sm, lo, mid, warp, lane, px, py, prm, T, acc);
      if (w0 + kAlign < end) put_ckpt(w0 + kAlign);
      blend_rows<TILE, MODE>(sm, mid, hi, warp, lane, px, py, prm, T, acc);
      if (w0 + kChunk < end) put_ckpt(w0 + kChunk);
    }
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int64_t o =
        static_cast<int64_t>(t) * kPixels + pixel_of(warp, lane, i);
    out_rgb[o * 3 + 0] = acc[i][0];
    out_rgb[o * 3 + 1] = acc[i][1];
    out_rgb[o * 3 + 2] = acc[i][2];
    out_trans[o] = T[i];
  }
  if (TRAIN && tid == 0) out_nproc[t] = ci;
}

// Call f(kernel, threads) with the kernel instantiation of this mode.
template <int TILE, bool TRAIN, bool SEEDED, typename F>
int by_mode(int mode, F&& f) {
  constexpr int n = Geo<TILE>::kThreads;
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
}

// ... and of this tile size: 8, 16 or 32 for inference, 16 for training.
template <bool TRAIN, bool SEEDED, typename F>
int by_tile(int tile, int mode, F&& f) {
  if (tile == 16) return by_mode<16, TRAIN, SEEDED>(mode, f);
  if constexpr (!TRAIN) {
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
