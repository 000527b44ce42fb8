// Kernel P1s: projection and SH colour of every surfel (2D Gaussian
// splatting, Huang et al. 2024), one thread per surfel: the whole of
// ops/projection.py _project_surfel in registers, built from
// projection.cu's helpers (the camera staging, the cp.async SH rows, the
// GEMM-rounded view_clip, the SH basis, the disparity) into a library of
// its own, which a 3DGS render never builds or loads.
//
//   gsv_project_surfel_fwd  P1s: xyz, rot, scale (N, 2), opacity, sh and
//                           the camera -> mean2d (N,2), depth (N),
//                           transform (N,9), radius (N,2), color (N,3),
//                           valid (N) bool.
//
// Per surfel: the culls, depth and colour of P1; the rows Tu, Tv, Tw of
// the homography H = M [[s_u r1, s_v r2, mu], [0, 0, 1]], M being the
// world -> (x w, y w, w) pixel map (P V, then mean2d's ndc -> pixel map),
// so H's columns are the images of the scaled tangent axes r1, r2
// (directions) and of the centre (its clip coordinates from view_clip);
// then the official rasterizer's compute_aabb: the 3-sigma ellipse's
// centre c (mean2d) and half-extents e from the dual conic diag(9, 9, -1),
// radius = ceil(max(e_x, e_y, 3 sqrt(2) / 2)) on both axes, invalid where
// d = sum t Tw^2 is 0.  The expressions and their order are the plain
// version's (its sums written out left to right), and without FMA
// contraction every output but colour is the plain version's on the card
// bit for bit, as P1's are.
//
// What bounds it on an H100: memory, as P1: per surfel it reads xyz, rot,
// two scales, opacity and 48 SH floats (232 B) and writes 69 B (T's 36 in
// place of the conic's 12); ~350 FP32 operations.  The design is P1's.

#define GSV_PROJECTION_SURFEL
#include "projection.cu"

namespace {

constexpr float kCutoff2 = 9.0f;  // the 3-sigma ellipse: cutoff^2
// 3 sqrt(2) / 2: the 3-sigma extent of the sigma = sqrt(2) / 2 low-pass
constexpr float kLowPassExtent = 2.1213203435596424f;

// A world direction d's image (x w, y w, w) under M; the camera's view
// rows and projection as staged.
__device__ __forceinline__ void image_of(const float* c, const Args& a,
                                         float d0, float d1, float d2,
                                         float* h) {
  const float* V = c + kV;
  const float* P = c + kP;
  float v[3];
  for (int k = 0; k < 3; ++k) {
    v[k] = d0 * V[4 * k] + d1 * V[4 * k + 1] + d2 * V[4 * k + 2];
  }
  const float cx = v[0] * P[0] + v[1] * P[1] + v[2] * P[2];
  const float cy = v[0] * P[4] + v[1] * P[5] + v[2] * P[6];
  const float cw = v[0] * P[12] + v[1] * P[13] + v[2] * P[14];
  h[0] = (cx + cw) * (0.5f * a.width);
  h[1] = (cw - cy) * (0.5f * a.height);
  h[2] = cw;
}

template <int DEG, bool DEPTH>
__global__ void __launch_bounds__(kBlock)
    project_surfel_fwd_kernel(Args a, float* __restrict__ mean2d,
                              float* __restrict__ depth,
                              float* __restrict__ transform,
                              float* __restrict__ radius,
                              float* __restrict__ color,
                              uint8_t* __restrict__ valid) {
  constexpr int NB = Sh<DEG>::coeffs, SS = Sh<DEG>::stride;
  __shared__ float cam[kConsts];
  __shared__ float tile[DEPTH ? 1 : kBlock * SS];
  const Rows blk = block_rows(a);
  const long long i = blk.i;
  const int t = blk.t;
  const float x = a.xyz[3 * i], y = a.xyz[3 * i + 1], z = a.xyz[3 * i + 2];
  const float qw = a.rot[4 * i], qx = a.rot[4 * i + 1],
              qy = a.rot[4 * i + 2], qz = a.rot[4 * i + 3];
  const float su = a.scale[2 * i] * a.scale_mult;
  const float sv = a.scale[2 * i + 1] * a.scale_mult;
  const float opacity = a.opacity[i];
  if (!DEPTH) {
    load_rows(tile, SS, a.sh, a.sh_width, Sh<DEG>::floats, blk.row0,
              blk.rows);
  }
  stage_camera(cam, a);
  wait_async();
  __syncthreads();
  if (!blk.live) return;

  Geometry g;  // the centre's culls (and ndc0 for the disparity)
  float c0, c1, c2;
  view_clip(cam, x, y, z, g.m0, g.m1, g.m2, c0, c1, c2, g.c3);
  g.w_small = fabsf(g.c3) < DIV_EPS;
  g.ws = g.w_small ? DIV_EPS : g.c3;
  g.ndc0 = c0 / g.ws;
  g.ndc1 = c1 / g.ws;
  const float ndc2 = c2 / g.ws;
  g.in_frustum = fabsf(g.ndc0) <= a.ndc_lim && fabsf(g.ndc1) <= a.ndc_lim &&
                 fabsf(ndc2) <= a.ndc_lim && g.c3 > DIV_EPS;

  // H's columns: the images of s_u r1, s_v r2 and of the centre
  const float r10 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float r11 = 2.0f * (qx * qy + qw * qz);
  const float r12 = 2.0f * (qx * qz - qw * qy);
  const float r20 = 2.0f * (qx * qy - qw * qz);
  const float r21 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float r22 = 2.0f * (qy * qz + qw * qx);
  float hu[3], hv[3];
  image_of(cam, a, r10 * su, r11 * su, r12 * su, hu);
  image_of(cam, a, r20 * sv, r21 * sv, r22 * sv, hv);
  const float hm[3] = {(c0 + g.c3) * (0.5f * a.width),
                       (g.c3 - c1) * (0.5f * a.height), g.c3};
  const float tu[3] = {hu[0], hv[0], hm[0]};
  const float tv[3] = {hu[1], hv[1], hm[1]};
  const float tw[3] = {hu[2], hv[2], hm[2]};

  // compute_aabb: the dual conic of the cutoff circle, t = (9, 9, -1)
  const float tt[3] = {kCutoff2, kCutoff2, -1.0f};
  const float d = tt[0] * tw[0] * tw[0] + tt[1] * tw[1] * tw[1] +
                  tt[2] * tw[2] * tw[2];
  const bool ok = d != 0.0f;
  const float ds = ok ? d : 1.0f;
  const float f[3] = {tt[0] / ds, tt[1] / ds, tt[2] / ds};
  const float cx = f[0] * tu[0] * tw[0] + f[1] * tu[1] * tw[1] +
                   f[2] * tu[2] * tw[2];
  const float cy = f[0] * tv[0] * tw[0] + f[1] * tv[1] * tw[1] +
                   f[2] * tv[2] * tw[2];
  const float hx = cx * cx - (f[0] * tu[0] * tu[0] + f[1] * tu[1] * tu[1] +
                              f[2] * tu[2] * tu[2]);
  const float hy = cy * cy - (f[0] * tv[0] * tv[0] + f[1] * tv[1] * tv[1] +
                              f[2] * tv[2] * tv[2]);
  const float ex = sqrtf(tmax(hx, 1e-4f));
  const float ey = sqrtf(tmax(hy, 1e-4f));
  const float r = ceilf(tmax(tmax(ex, ey), kLowPassExtent));

  float col[3];
  if (DEPTH) {
    Disparity dp;
    disparity(dp, cam, a, g, x, y, z);
    col[0] = col[1] = col[2] = fabsf(dp.diff);
  } else {
    Direction dir;
    direction(dir, cam, x, y, z);
    float b[NB];
    sh_basis<DEG>(dir.e[0], dir.e[1], dir.e[2], b);
    const float* s = tile + t * SS;
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NB; ++k) acc += b[k] * s[3 * k + ch];
      acc = acc + 0.5f;
      col[ch] = a.clamp ? tmax(acc, 0.0f) : acc;
    }
  }

  reinterpret_cast<float2*>(mean2d)[i] = make_float2(cx, cy);
  depth[i] = -g.m2;
  float* tr = transform + 9 * i;
  for (int k = 0; k < 3; ++k) {
    tr[k] = tu[k];
    tr[3 + k] = tv[k];
    tr[6 + k] = tw[k];
  }
  reinterpret_cast<float2*>(radius)[i] = make_float2(r, r);
  for (int ch = 0; ch < 3; ++ch) color[3 * i + ch] = col[ch];
  valid[i] = g.in_frustum && ok && opacity > 0.0f;
}

int dispatch_surfel(const Args& a, int degree, bool depth_mode,
                    float* mean2d, float* depth, float* transform,
                    float* radius, float* color, uint8_t* valid,
                    cudaStream_t stream) {
  if (a.n <= 0) return 0;
  const dim3 grid((a.n + kBlock - 1) / kBlock);
  auto go = [&](auto deg, auto dm) {
    constexpr int D = decltype(deg)::value;
    constexpr bool M = decltype(dm)::value;
    project_surfel_fwd_kernel<D, M><<<grid, kBlock, 0, stream>>>(
        a, mean2d, depth, transform, radius, color, valid);
  };
  using F = std::false_type;
  if (depth_mode) {
    go(std::integral_constant<int, 0>(), std::true_type());
  } else {
    switch (degree) {
      case 0: go(std::integral_constant<int, 0>(), F()); break;
      case 1: go(std::integral_constant<int, 1>(), F()); break;
      case 2: go(std::integral_constant<int, 2>(), F()); break;
      case 3: go(std::integral_constant<int, 3>(), F()); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gsv_project_surfel_fwd(
    const float* xyz, const float* rot, const float* scale,
    const float* opacity, const float* sh, int sh_width, int n, int degree,
    int depth_mode, const float* view, const float* proj,
    const float* cam_pos, float width, float height, float scale_mult,
    float ndc_lim, float baseline, int clamp, float* mean2d, float* depth,
    float* transform, float* radius, float* color, unsigned char* valid,
    void* stream) {
  const Args a = make_args(xyz, rot, scale, opacity, sh, sh_width, n, view,
                           proj, cam_pos, width, height, scale_mult, ndc_lim,
                           baseline, clamp);
  return dispatch_surfel(a, degree, depth_mode != 0, mean2d, depth,
                         transform, radius, color, valid,
                         static_cast<cudaStream_t>(stream));
}
