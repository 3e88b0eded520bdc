// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vlm_fo1_tpu/ops/msda_pallas.py
// (`_msda_level_kernel`, launched by `_pass_call` via `_msda_pallas` /
// `ms_deform_attn_core_flat`). It computes what `ms_deform_attn_core`
// (vlm_fo1_tpu/ops/msda.py) defines: for every (batch, query, head), the
// sum over levels and points of attention weight x bilinear sample of that
// level's value map, sampled as grid_sample(align_corners=False) with zeros
// padding: x = loc_x * W - 0.5, y = loc_y * H - 0.5, in fp32, and each of the
// four corners outside the map reads 0.
//
// Layouts (the JAX package's 6-D public layout): value [B, S, M, D] in
// float32 or bfloat16 (S = sum of the levels' H*W, level l starting at row
// start[l]); locations [B, Lq, M, L, P, 2] and weights [B, Lq, M, L, P] in
// float32; output [B, Lq, M, D] in float32.
//
// What bounds it on the card: memory traffic. Each sample does 4 corner
// reads and ~10 FLOPs per channel, while the locations and weights (12 bytes
// per sample and head) stream once from device memory and the value maps are
// read many times over. At the UPN encoder's shape (Lq = S = 85,932, M = 8,
// L = 5, P = 4, D = 32) one call moves ~300 MB at least and does ~3.5 GFLOP.
//
// Design: the TPU kernel's quad-packed maps, one-hot MXU selection matmuls,
// row bands and level grouping exist because the TPU has no fast gather; the
// card has one. So this is the reference CUDA im2col's shape: one group of
// TPG lanes per (batch, query, head), lane = channel. At D = 32 a group is a
// warp and one corner read is one coalesced 64-byte row in bfloat16, and the
// level maps (44 MB in bfloat16 at the encoder's shape) mostly stay in the
// 50 MB L2. Smaller heads (D = 8, 16) pack 4 or 2 groups into a warp; wider
// heads (D <= 128) give each lane up to 4 channels. Per level, the group's
// lanes load P (location, weight) triples side by side and pass each one to
// all lanes with a warp shuffle. Accumulation is fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_LEVELS = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int TPG, int CPT>
__global__ void __launch_bounds__(NTHREADS)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, float* __restrict__ out,
                Levels lv, int s, int m, int d, int lq, int nlevels,
                int npoints, long long groups) {
  const int lane = threadIdx.x % TPG;
  const long long g =
      (long long)blockIdx.x * (NTHREADS / TPG) + threadIdx.x / TPG;
  // lanes past the last group still take part in the shuffles
  const bool active = g < groups;
  const long long gg = active ? g : 0;  // ((b * Lq) + q) * M + head
  const int head = (int)(gg % m);
  const long long b = gg / m / lq;
  const int lp = nlevels * npoints;
  const float* loc_g = loc + gg * lp * 2;
  const float* aw_g = aw + gg * lp;
  const size_t row = (size_t)m * d;  // elements between neighbouring pixels
  const T* val_b = value + (size_t)b * s * row + (size_t)head * d;

  float acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) acc[k] = 0.f;

  for (int l = 0; l < nlevels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float hf = (float)hl, wf = (float)wl;
    const T* val_l = val_b + (size_t)lv.start[l] * row;
    for (int p0 = 0; p0 < npoints; p0 += TPG) {
      const int i = l * npoints + p0 + lane;
      float lx = 0.f, ly = 0.f, a = 0.f;
      if (active && p0 + lane < npoints) {
        lx = loc_g[2 * i];
        ly = loc_g[2 * i + 1];
        a = aw_g[i];
      }
      const int n = min(TPG, npoints - p0);
      for (int j = 0; j < n; ++j) {
        const float sx = __shfl_sync(FULL, lx, j, TPG);
        const float sy = __shfl_sync(FULL, ly, j, TPG);
        const float sa = __shfl_sync(FULL, a, j, TPG);
        // rounded as the plain version's two elementwise ops, never fused
        // into one multiply-add: the same cell for a location on an edge
        // (msda_bwd.cu, whose location gradient jumps there, does the same)
        const float x = __fsub_rn(__fmul_rn(sx, wf), 0.5f);
        const float y = __fsub_rn(__fmul_rn(sy, hf), 0.5f);
        // all four corners outside the map (also catches NaN)
        if (!(x > -1.f && x < wf && y > -1.f && y < hf)) continue;
        const float x0f = floorf(x), y0f = floorf(y);
        const float fx = x - x0f, fy = y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        const bool l0 = x0 >= 0, r1 = x0 + 1 < wl;
        const bool t0 = y0 >= 0, b1 = y0 + 1 < hl;
        const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
        const float w10 = fy * (1.f - fx), w11 = fy * fx;
        const T* p00 = val_l + ((long long)y0 * wl + x0) * (long long)row;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int c = lane + k * TPG;
          if (c < d) {
            float v = 0.f;
            if (t0 && l0) v += w00 * to_f(p00[c]);
            if (t0 && r1) v += w01 * to_f(p00[row + c]);
            if (b1 && l0) v += w10 * to_f(p00[(size_t)wl * row + c]);
            if (b1 && r1) v += w11 * to_f(p00[((size_t)wl + 1) * row + c]);
            acc[k] += sa * v;
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = lane + k * TPG;
    if (c < d) out[gg * d + c] = acc[k];
  }
}

template <typename T, int TPG, int CPT>
cudaError_t launch(const void* value, const float* loc, const float* aw,
                   float* out, const Levels& lv, int b, int s, int m, int d,
                   int lq, int nlevels, int npoints, cudaStream_t stream) {
  const long long groups = (long long)b * lq * m;
  const long long per_block = NTHREADS / TPG;
  const long long blocks = (groups + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_fwd_kernel<T, TPG, CPT><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(value), loc, aw, out, lv, s, m, d, lq, nlevels,
      npoints, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* value, const float* loc, const float* aw,
                       float* out, const Levels& lv, int b, int s, int m,
                       int d, int lq, int nlevels, int npoints,
                       cudaStream_t stream) {
#define MSDA_CASE(DMAX, TPG, CPT)                                       \
  if (d <= DMAX)                                                        \
    return launch<T, TPG, CPT>(value, loc, aw, out, lv, b, s, m, d, lq, \
                               nlevels, npoints, stream);
  MSDA_CASE(8, 8, 1)
  MSDA_CASE(16, 16, 1)
  MSDA_CASE(32, 32, 1)
  MSDA_CASE(64, 32, 2)
  MSDA_CASE(96, 32, 3)
  MSDA_CASE(128, 32, 4)
#undef MSDA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// levels: host array [nlevels][3] of (H, W, first row in S). dtype of value:
// 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch (0 on
// success); the launch does not synchronise.
extern "C" int fo1_msda_fwd(const void* value, const void* loc,
                            const void* aw, void* out, const int* levels,
                            int b, int s, int m, int d, int lq, int nlevels,
                            int npoints, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || m <= 0 || d <= 0 || d > 128 || lq <= 0 ||
      nlevels <= 0 || nlevels > MAX_LEVELS || npoints <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < nlevels; ++l) {
    const int h = levels[3 * l], w = levels[3 * l + 1];
    const int start = levels[3 * l + 2];
    if (h <= 0 || w <= 0 || start < 0 || (long long)start + (long long)h * w > s)
      return (int)cudaErrorInvalidValue;
    lv.h[l] = h;
    lv.w[l] = w;
    lv.start[l] = start;
  }
  const float* lf = static_cast<const float*>(loc);
  const float* af = static_cast<const float*>(aw);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(value, lf, af, of, lv, b, s, m, d, lq,
                                  nlevels, npoints, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(value, lf, af, of, lv, b, s, m, d,
                                          lq, nlevels, npoints, st);
  return (int)cudaErrorInvalidValue;
}
