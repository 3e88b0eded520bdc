// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vlm_fo1_tpu/ops/msda_pallas_bwd.py
// (`_bwd_kernel`, launched by `_bwd_pass_call` via `msda_backward_pallas`,
// the backward of the `custom_vjp` `ms_deform_attn_core_flat`). It computes
// what `jax.vjp` of `ms_deform_attn_core` (vlm_fo1_tpu/ops/msda.py) gives.
// For each (batch, query, head, level, point), with x = loc_x * W - 0.5,
// y = loc_y * H - 0.5 in fp32 (the forward's floor and fractions lx, ly),
// attention weight a, bilinear corner weights w_c and s_c = <g, v_c> over
// the head's D channels for each corner c (0 for a corner off the map):
//   grad_aw    = sum_c w_c * s_c
//   grad_loc_x = a * ((1 - ly)(s01 - s00) + ly (s11 - s10)) * W
//   grad_loc_y = a * ((1 - lx)(s10 - s00) + lx (s11 - s01)) * H
//   grad_value[corner c] += a * w_c * g   for each corner on the map.
// A sample whose whole 2x2 window lies off the map (the JAX `ok` mask:
// floor(x) outside [-1, W-1] or floor(y) outside [-1, H-1]) gets zeros.
//
// Layouts (the JAX package's 6-D public layout): value [B, S, M, D] in
// float32 or bfloat16; locations [B, Lq, M, L, P, 2], weights
// [B, Lq, M, L, P] and g [B, Lq, M, D] in float32. Outputs: grad_value into
// a zeroed float32 map [B, S, M, D] (the caller casts it to value's dtype),
// grad_loc and grad_aw float32 in the locations' and weights' layouts.
//
// What bounds it on the card: the function moves value, g, locations and
// weights once and writes the three gradients once (~0.5 GB at the UPN
// encoder's shape, Lq = S = 85,932, M = 8, L = 5, P = 4, D = 32, in
// bfloat16, ~0.15 ms at 3.35 TB/s), but the scatter into grad_value is
// B*Lq*M*L*P*4*D float32 atomic adds (~1.76e9 at that shape) into an 88 MB
// map that mostly stays in the 50 MB L2; the atomics, not the bytes, are
// expected to set the time.
//
// Design: the forward's thread map and coordinate arithmetic
// (csrc/msda.cu). One group of TPG lanes per (batch, query, head), lane =
// channel (D = 8, 16 pack 4 or 2 groups into a warp; D <= 128 gives each
// lane up to 4 channels); g's channels stay in registers for the whole
// group. Per level the lanes load P (location, weight) triples side by side
// and pass each to all lanes with a warp shuffle. Per sample each lane reads its channels of the four corners,
// adds a * w_c * g to them with float32 atomics (neighbouring lanes hit
// neighbouring addresses), and keeps its share of grad_aw and the two
// location sums; shuffles reduce those three over the group, and one lane
// writes them: each of those slots belongs to exactly one group, so they
// need no atomics. The TPU kernel's quad packing, supergroup one-hot
// scatter matmuls and VMEM bands exist because the TPU has no fast gather or
// scatter; none of it is carried over. Sums in grad_value land in whatever
// order the atomics arrive, so its low bits differ from run to run.

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

template <int TPG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = TPG / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off, TPG);
  return v;
}

template <typename T, int TPG, int CPT>
__global__ void __launch_bounds__(NTHREADS)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const float* __restrict__ gout,
                float* __restrict__ gvalue, float* __restrict__ gloc,
                float* __restrict__ gaw, Levels lv, int s, int m, int d,
                int lq, int nlevels, int npoints, long long groups) {
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
  float* gloc_g = gloc + gg * lp * 2;
  float* gaw_g = gaw + gg * lp;
  const size_t row = (size_t)m * d;  // elements between neighbouring pixels
  const size_t off_b = (size_t)b * s * row + (size_t)head * d;

  float go[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = lane + k * TPG;
    go[k] = (active && c < d) ? gout[gg * d + c] : 0.f;
  }

  for (int l = 0; l < nlevels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float hf = (float)hl, wf = (float)wl;
    const T* val_l = value + off_b + (size_t)lv.start[l] * row;
    float* gval_l = gvalue + off_b + (size_t)lv.start[l] * row;
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
        // a product and a difference rounded apart, as the plain version's
        // two elementwise ops (`loc * W - 0.5`); a fused multiply-add can
        // round a location on a cell edge (UPN's encoder samples sit on
        // them) to the other side, where the location gradient jumps
        const float x = __fsub_rn(__fmul_rn(sx, wf), 0.5f);
        const float y = __fsub_rn(__fmul_rn(sy, hf), 0.5f);
        // the JAX `ok` window test (false for NaN); no early exit, since
        // every lane of the warp must reach the shuffles below
        const bool ok = active && x >= -1.f && x < wf && y >= -1.f && y < hf;
        float fx = 0.f, fy = 0.f;
        bool c00 = false, c01 = false, c10 = false, c11 = false;
        long long base = 0;
        if (ok) {
          const float x0f = floorf(x), y0f = floorf(y);
          fx = x - x0f;
          fy = y - y0f;
          const int x0 = (int)x0f, y0 = (int)y0f;
          const bool l0 = x0 >= 0, r1 = x0 + 1 < wl;
          const bool t0 = y0 >= 0, b1 = y0 + 1 < hl;
          c00 = t0 && l0;
          c01 = t0 && r1;
          c10 = b1 && l0;
          c11 = b1 && r1;
          base = ((long long)y0 * wl + x0) * (long long)row;
        }
        const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
        const float w10 = fy * (1.f - fx), w11 = fy * fx;
        const long long o01 = (long long)row;
        const long long o10 = (long long)wl * row;
        const long long o11 = o10 + (long long)row;
        float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int c = lane + k * TPG;
          if (c < d) {
            const float gk = go[k];
            const float ag = sa * gk;
            const long long o = base + c;
            if (c00) {
              s00 += gk * to_f(val_l[o]);
              atomicAdd(gval_l + o, ag * w00);
            }
            if (c01) {
              s01 += gk * to_f(val_l[o + o01]);
              atomicAdd(gval_l + o + o01, ag * w01);
            }
            if (c10) {
              s10 += gk * to_f(val_l[o + o10]);
              atomicAdd(gval_l + o + o10, ag * w10);
            }
            if (c11) {
              s11 += gk * to_f(val_l[o + o11]);
              atomicAdd(gval_l + o + o11, ag * w11);
            }
          }
        }
        const float pa = group_sum<TPG>(w00 * s00 + w01 * s01 + w10 * s10 +
                                        w11 * s11);
        const float px = group_sum<TPG>((1.f - fy) * (s01 - s00) +
                                        fy * (s11 - s10));
        const float py = group_sum<TPG>((1.f - fx) * (s10 - s00) +
                                        fx * (s11 - s01));
        if (active && lane == j) {
          const int o = l * npoints + p0 + j;
          gaw_g[o] = pa;
          gloc_g[2 * o] = sa * px * wf;
          gloc_g[2 * o + 1] = sa * py * hf;
        }
      }
    }
  }
}

template <typename T, int TPG, int CPT>
cudaError_t launch(const void* value, const float* loc, const float* aw,
                   const float* gout, float* gvalue, float* gloc, float* gaw,
                   const Levels& lv, int b, int s, int m, int d, int lq,
                   int nlevels, int npoints, cudaStream_t stream) {
  const long long groups = (long long)b * lq * m;
  const long long per_block = NTHREADS / TPG;
  const long long blocks = (groups + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_bwd_kernel<T, TPG, CPT><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(value), loc, aw, gout, gvalue, gloc, gaw, lv, s,
      m, d, lq, nlevels, npoints, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* value, const float* loc, const float* aw,
                       const float* gout, float* gvalue, float* gloc,
                       float* gaw, const Levels& lv, int b, int s, int m,
                       int d, int lq, int nlevels, int npoints,
                       cudaStream_t stream) {
#define MSDA_CASE(DMAX, TPG, CPT)                                        \
  if (d <= DMAX)                                                         \
    return launch<T, TPG, CPT>(value, loc, aw, gout, gvalue, gloc, gaw, \
                               lv, b, s, m, d, lq, nlevels, npoints,     \
                               stream);
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
// 0 = float32, 1 = bfloat16. gvalue must be zeroed float32 [B, S, M, D].
// Returns the cudaError_t of the launch (0 on success); the launch does not
// synchronise.
extern "C" int fo1_msda_bwd(const void* value, const void* loc,
                            const void* aw, const void* gout, void* gvalue,
                            void* gloc, void* gaw, const int* levels, int b,
                            int s, int m, int d, int lq, int nlevels,
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
  const float* gf = static_cast<const float*>(gout);
  float* gv = static_cast<float*>(gvalue);
  float* gl = static_cast<float*>(gloc);
  float* ga = static_cast<float*>(gaw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(value, lf, af, gf, gv, gl, ga, lv, b, s, m,
                                  d, lq, nlevels, npoints, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(value, lf, af, gf, gv, gl, ga, lv,
                                          b, s, m, d, lq, nlevels, npoints,
                                          st);
  return (int)cudaErrorInvalidValue;
}
