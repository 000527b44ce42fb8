// Tile blend forward: front-to-back alpha blending of the depth-sorted
// splat rows of each 16x16-pixel tile.  One kernel template, two entry
// points:
//
//   gsv_tile_raster_fwd        kernel B1, the inference blend;
//   gsv_tile_raster_fwd_train  kernel B2, B1 plus the backward's residuals.
//
// Replaces: gaussiansplattingviewer_tpu/ops/pallas/tile_raster_fwd.py,
// _fwd_kernel (seeded=False) as launched by rasterize_binned_pallas_soa
// (with_ckpt=False, B1) and by rasterize_binned_pallas_train
// (with_ckpt=True, B2).
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
// What bounds it on an H100: FP32 throughput.  Each (pixel, row) fragment
// costs ~30 FP32 operations and one expf, while a row's 11 attributes
// (44 bytes) are shared by the tile's 256 pixels: ~175 operations per byte,
// far above the card's ~20 FP32 operations per byte of HBM bandwidth.
// Design: one CTA per tile, one thread per pixel, so every fragment's
// state (T, rgb) stays in registers; each window's rows are loaded once,
// coalesced, into shared memory and read by all 256 threads as broadcasts
// (no bank conflicts).  The TPU kernel's log-domain prefix product on the
// MXU and its DMA double-buffering are TPU devices and are not carried
// over: a thread composites its rows sequentially.  B2 adds two coalesced
// 1 KB checkpoint stores per window and one int per tile.
//
// Built with -fmad=false and without --use_fast_math (see
// ops/kernels/build.py): the discrete thresholds then see exactly the
// values the plain PyTorch version computes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // one thread per pixel
constexpr int kChunk = 256;             // rows per window
constexpr int kAlign = 128;             // window alignment
constexpr int kAttrs = 11;              // table rows 0..10 (cx .. ry)

// table row indices (ops/binning.py column map)
constexpr int kCx = 0, kCy = 1, kA = 2, kB = 3, kC = 4;
constexpr int kR = 5, kG = 6, kBch = 7, kOpacity = 8, kRx = 9, kRy = 10;

enum Mode { kGauss = 0, kBillboard = 1, kFlatBall = 2, kGaussBall = 3 };

// Composite table rows [j0, j1) of the staged window into one pixel.
template <int MODE>
__device__ __forceinline__ void blend_rows(
    const float (*rows)[kChunk], int j0, int j1, float px, float py,
    float alpha_clamp, float alpha_min, float ball_threshold, float& T,
    float& acc_r, float& acc_g, float& acc_b) {
  for (int j = j0; j < j1; ++j) {
    const float dx = px - rows[kCx][j];
    const float dy = py - rows[kCy][j];
    const float power = -0.5f * (rows[kA][j] * dx * dx +
                                 rows[kC][j] * dy * dy) -
                        rows[kB][j] * dx * dy;
    const bool in_rect =
        fabsf(dx) <= rows[kRx][j] && fabsf(dy) <= rows[kRy][j];
    float alpha, weight;
    if (MODE == kBillboard) {
      alpha = in_rect ? 1.0f : 0.0f;
      weight = alpha * T;
    } else {
      const float gauss = expf(power);
      alpha = fminf(alpha_clamp, rows[kOpacity][j] * gauss);
      const bool keep = in_rect && power <= 0.0f && alpha >= alpha_min;
      alpha = keep ? alpha : 0.0f;
      if (MODE == kFlatBall || MODE == kGaussBall) {
        alpha = (keep && alpha > ball_threshold) ? 1.0f : 0.0f;
      }
      weight = alpha * T;
      if (MODE == kGaussBall) weight = weight * gauss;
    }
    acc_r += weight * rows[kR][j];
    acc_g += weight * rows[kG][j];
    acc_b += weight * rows[kBch][j];
    T = T * (1.0f - alpha);
  }
}

// TRAIN = false is kernel B1, TRAIN = true kernel B2 (nproc and ckpt are
// written only then).
template <int MODE, bool TRAIN>
__global__ void __launch_bounds__(kPixels) tile_raster_fwd_kernel(
    const float* __restrict__ table, int64_t dpad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    int row_offset, int tiles_x, int row_stride, float alpha_clamp,
    float alpha_min, float ball_threshold, float early_stop,
    float* __restrict__ out_rgb, float* __restrict__ out_trans,
    int* __restrict__ out_nproc, float* __restrict__ ckpt) {
  __shared__ float rows[kAttrs][kChunk];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = starts[t];
  const int end = start + counts[t];
  const int base = (start / kAlign) * kAlign;
  const int num_chunks = end > start ? (end - base + kChunk - 1) / kChunk : 0;

  const float tx = static_cast<float>(t % tiles_x);
  const float ty = static_cast<float>((t / tiles_x) * row_stride + row_offset);
  const float px = tx * kTile + static_cast<float>(p % kTile) + 0.5f;
  const float py = ty * kTile + static_cast<float>(p / kTile) + 0.5f;
  // this pixel's slot in a checkpoint window: ckpt[p / 128][c + p % 128]
  const int64_t ck_off = static_cast<int64_t>(p / kAlign) * dpad + p % kAlign;

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int ci = 0;
  for (; ci < num_chunks; ++ci) {
    // tile-wide stop; also the barrier before rows[] is overwritten
    if (!__syncthreads_or(T > early_stop)) break;
    const int w0 = base + ci * kChunk;
    const int col = w0 + p;
    if (col >= start && col < end) {
#pragma unroll
      for (int a = 0; a < kAttrs; ++a) {
        rows[a][p] = table[static_cast<int64_t>(a) * dpad + col];
      }
    }
    __syncthreads();
    const int lo = max(start - w0, 0);
    const int hi = min(end - w0, kChunk);
    if (!TRAIN) {
      blend_rows<MODE>(rows, lo, hi, px, py, alpha_clamp, alpha_min,
                       ball_threshold, T, acc_r, acc_g, acc_b);
    } else {
      // the window's two 128-row blocks; each block's exiting T is the
      // next block's entering checkpoint, written only where that block
      // holds live rows of this tile (see the header on write races)
      const int mid = min(max(lo, kAlign), hi);
      blend_rows<MODE>(rows, lo, mid, px, py, alpha_clamp, alpha_min,
                       ball_threshold, T, acc_r, acc_g, acc_b);
      if (w0 + kAlign < end) ckpt[ck_off + w0 + kAlign] = T;
      blend_rows<MODE>(rows, mid, hi, px, py, alpha_clamp, alpha_min,
                       ball_threshold, T, acc_r, acc_g, acc_b);
      if (w0 + kChunk < end) ckpt[ck_off + w0 + kChunk] = T;
    }
  }
  const int64_t o = static_cast<int64_t>(t) * kPixels + p;
  out_rgb[o * 3 + 0] = acc_r;
  out_rgb[o * 3 + 1] = acc_g;
  out_rgb[o * 3 + 2] = acc_b;
  out_trans[o] = T;
  if (TRAIN && p == 0) out_nproc[t] = ci;
}

template <bool TRAIN>
int launch(const float* table, long long dpad, const int* starts,
           const int* counts, int num_tiles, int row_offset, int tiles_x,
           int row_stride, int mode, float alpha_clamp, float alpha_min,
           float ball_threshold, float early_stop, float* out_rgb,
           float* out_trans, int* out_nproc, float* ckpt, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(num_tiles), block(kPixels);
#define GSV_LAUNCH(M)                                                       \
  tile_raster_fwd_kernel<M, TRAIN><<<grid, block, 0, s>>>(                  \
      table, dpad, starts, counts, row_offset, tiles_x, row_stride,         \
      alpha_clamp, alpha_min, ball_threshold, early_stop, out_rgb,          \
      out_trans, out_nproc, ckpt)
  switch (mode) {
    case kGauss: GSV_LAUNCH(kGauss); break;
    case kBillboard: GSV_LAUNCH(kBillboard); break;
    case kFlatBall: GSV_LAUNCH(kFlatBall); break;
    case kGaussBall: GSV_LAUNCH(kGaussBall); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gsv_tile_raster_fwd(
    const float* table, long long dpad, const int* starts, const int* counts,
    int num_tiles, int row_offset, int tiles_x, int row_stride, int mode,
    float alpha_clamp, float alpha_min, float ball_threshold,
    float early_stop, float* out_rgb, float* out_trans, void* stream) {
  return launch<false>(table, dpad, starts, counts, num_tiles, row_offset,
                       tiles_x, row_stride, mode, alpha_clamp, alpha_min,
                       ball_threshold, early_stop, out_rgb, out_trans,
                       nullptr, nullptr, stream);
}

extern "C" int gsv_tile_raster_fwd_train(
    const float* table, long long dpad, const int* starts, const int* counts,
    int num_tiles, int row_offset, int tiles_x, int row_stride, int mode,
    float alpha_clamp, float alpha_min, float ball_threshold,
    float early_stop, float* out_rgb, float* out_trans, int* out_nproc,
    float* ckpt, void* stream) {
  return launch<true>(table, dpad, starts, counts, num_tiles, row_offset,
                      tiles_x, row_stride, mode, alpha_clamp, alpha_min,
                      ball_threshold, early_stop, out_rgb, out_trans,
                      out_nproc, ckpt, stream);
}

extern "C" const char* gsv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
