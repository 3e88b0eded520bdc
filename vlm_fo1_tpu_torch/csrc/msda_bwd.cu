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
// encoder's shape, Lq = S = 85,932, M = 8, L = 5, P = 4, D = 32, in bfloat16,
// ~0.15 ms at 3.35 TB/s), but the scatter into grad_value adds B*Lq*M*L*P*4*D
// float32 values (~1.76e9 at that shape) into an 88 MB map. The reductions set
// the time: at a UPN request's encoder inputs the kernel without them runs in
// a third of the time, and those into the three coarse levels cost most of the
// rest, their few pixels each taking hundreds to thousands of adds that queue
// up in L2 (PERF.md). The earlier design issued each add as a scalar atomic,
// from a warp per (batch, query, head) whose 32 lanes all repeated the
// coordinate arithmetic.
//
// Design (the thread map and windows of msda_common.cuh, as the forward): a
// team of 4 lanes per (batch, query, head) at D = 32, each lane 8 channels of
// g in registers; each sample's window computed once per team and shared
// through shared memory; the heads of a query side by side, which spreads the
// coarse levels' reductions over 8 rows (msda_common.cuh). A lane's 8 channels
// are two quads 4*G channels apart (lane i of the group: channels 4i..4i+3 and
// 4G+4i..), so the group's first reduction covers one contiguous 64 bytes of a
// corner's float32 row and its second the next 64: whole 32-byte sectors,
// where 8 contiguous channels a lane left every 16-byte reduction half a
// sector (1.5x slower, PERF.md). Per corner on the map a lane reads its two
// value quads and adds a * w_c * g to its two gradient quads with two vector
// reductions (`atomicAdd` on float4, `red.global.add.v4.f32` on sm_90): a
// quarter of the scalar design's atomic instructions. A corner of bilinear
// weight 0 (a sample on a cell edge) adds exactly 0 and issues none. grad_aw
// and grad_loc are reduced over the channel lanes with shuffles and written
// without atomics: each slot belongs to one team. The accumulation stays
// float32 (no bf16 atomics: the JAX backward sums in f32). Sums in grad_value
// land in whatever order the atomics arrive, so its low bits differ from run
// to run. Tried and dropped (PERF.md): shared-memory windows of the gradient
// map on the coarse levels (contended shared-memory atomics, 1.2-6x slower);
// scattering the coarse levels into copies of their maps chosen by query,
// summed by a second kernel (7% faster at the UPN encoder, for a second launch
// and a scratch of up to 24 MB each call).

#include "msda_common.cuh"

namespace {

using namespace msda;

// one sample's window as the backward reads it
struct __align__(16) BwdSample {
  int pix[4];
  float w[4];    // bilinear weights
  float a;       // attention weight
  float fx, fy;  // fractions of the window
  float scale_x; // the level's W (grad_loc_x = a * px * W)
  float scale_y; // the level's H
  int pad[3];
};

// A lane's 8 channels. VEC: two quads, at ca and cb (va, vb: inside D),
// loaded with 8- (bf16) or 16-byte (f32) loads and added with two float4
// reductions; else the 8 channels from ca on, nch of them, scalar.
struct Chans {
  int ca, cb;
  bool va, vb;
  int nch;
};

template <bool VEC, typename T>
__device__ __forceinline__ void load_ch(const T* p, const Chans& c,
                                        float (&v)[8]) {
  if (VEC) {
    if (c.va) load4(p + c.ca, v); else v[0] = v[1] = v[2] = v[3] = 0.f;
    if (c.vb) load4(p + c.cb, v + 4); else v[4] = v[5] = v[6] = v[7] = 0.f;
  } else {
    load8<false>(p + c.ca, c.nch, v);
  }
}

template <bool VEC>
__device__ __forceinline__ void red_ch(float* p, const Chans& c,
                                       const float (&v)[8]) {
  if (VEC) {
    if (c.va)
      atomicAdd(reinterpret_cast<float4*>(p + c.ca),
                make_float4(v[0], v[1], v[2], v[3]));
    if (c.vb)
      atomicAdd(reinterpret_cast<float4*>(p + c.cb),
                make_float4(v[4], v[5], v[6], v[7]));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < c.nch) atomicAdd(p + c.ca + k, v[k]);
  }
}

__device__ __forceinline__ BwdSample sample(const float* loc_g,
                                            const float* aw_g, const Levels& lv,
                                            int i, int npoints, bool on) {
  BwdSample smp;
  if (on) {
    const int l = i / npoints;
    int x0, y0;
    window<true>(loc_g[2 * i], loc_g[2 * i + 1], lv.h[l], lv.w[l],
                 lv.start[l], smp.pix, smp.w, smp.fx, smp.fy, x0, y0);
    smp.a = aw_g[i];
    smp.scale_x = (float)lv.w[l];
    smp.scale_y = (float)lv.h[l];
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) smp.pix[c] = -1, smp.w[c] = 0.f;
    smp.a = smp.fx = smp.fy = smp.scale_x = smp.scale_y = 0.f;
  }
  return smp;
}

template <typename T, int SPLIT, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const float* __restrict__ gout,
                float* __restrict__ gvalue, float* __restrict__ gloc,
                float* __restrict__ gaw, Levels lv, int b, int s, int m,
                int d, int lq, int nlevels, int npoints, int team_shift,
                int g, long long teams) {
  __shared__ BwdSample shared[MAX_TEAMS * CHUNK];
  const Team t = locate(team_shift, teams, b, lq, m, false);
  const int tsize = 1 << team_shift;
  const int ci = t.lane & (g - 1);
  const int k = t.lane / g;
  Chans ch;
  ch.ca = VEC ? 4 * ci : 8 * ci;
  ch.cb = VEC ? 4 * (g + ci) : 8 * ci + 4;
  ch.va = ch.ca < d;
  ch.vb = ch.cb < d;
  ch.nch = d - ch.ca;
  const bool any = ch.va;  // the lane holds channels
  const int lp = nlevels * npoints;
  const float* loc_g = loc + t.gq * lp * 2;
  const float* aw_g = aw + t.gq * lp;
  float* gloc_g = gloc + t.gq * lp * 2;
  float* gaw_g = gaw + t.gq * lp;
  const size_t row = (size_t)m * d;
  const size_t off_b = (size_t)t.b * s * row + (size_t)t.head * d;
  BwdSample* sh = shared + t.slot * CHUNK;

  float go[8];
  if (t.active && any) {
    load_ch<VEC>(gout + t.gq * d, ch, go);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) go[q] = 0.f;
  }

  for (int i0 = 0; i0 < lp; i0 += CHUNK) {
    for (int j = t.lane; j < CHUNK; j += tsize)
      sh[j] = sample(loc_g, aw_g, lv, i0 + j, npoints,
                     t.active && i0 + j < lp);
    __syncwarp();
    const int n = min(CHUNK, lp - i0);
#pragma unroll
    for (int jj = 0; jj < CHUNK / SPLIT; ++jj) {
      const int j = jj * SPLIT + k;
      const bool mine = j < n;
      const BwdSample smp = sh[mine ? j : 0];
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      if (mine && any) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (smp.pix[c] >= 0) {
            const size_t o = off_b + (size_t)smp.pix[c] * row;
            float v[8], add[8];
            load_ch<VEC>(value + o, ch, v);
            const float aw_c = smp.a * smp.w[c];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              sc[c] += go[q] * v[q];
              add[q] = aw_c * go[q];
            }
            // a corner of bilinear weight 0 (a sample on a cell edge)
            // adds exactly 0: no reduction
            if (smp.w[c] != 0.f) red_ch<VEC>(gvalue + o, ch, add);
          }
        }
      }
      float pa = smp.w[0] * sc[0] + smp.w[1] * sc[1] + smp.w[2] * sc[2] +
                 smp.w[3] * sc[3];
      float px = (1.f - smp.fy) * (sc[1] - sc[0]) + smp.fy * (sc[3] - sc[2]);
      float py = (1.f - smp.fx) * (sc[2] - sc[0]) + smp.fx * (sc[3] - sc[1]);
      // over the channel lanes of this group (every lane of the warp takes
      // part: the shuffles sit outside the per-lane conditions)
      for (int off = 1; off < g; off <<= 1) {
        pa += __shfl_xor_sync(FULL, pa, off);
        px += __shfl_xor_sync(FULL, px, off);
        py += __shfl_xor_sync(FULL, py, off);
      }
      if (t.active && mine && ci == 0) {
        const int i = i0 + j;
        gaw_g[i] = pa;
        gloc_g[2 * i] = smp.a * px * smp.scale_x;
        gloc_g[2 * i + 1] = smp.a * py * smp.scale_y;
      }
    }
    __syncwarp();
  }
}

template <typename T, int SPLIT, bool VEC>
cudaError_t launch(const void* value, const float* loc, const float* aw,
                   const float* gout, float* gvalue, float* gloc, float* gaw,
                   const Levels& lv, int b, int s, int m, int d, int lq,
                   int nlevels, int npoints, int g, cudaStream_t stream) {
  const long long teams = (long long)b * lq * m;
  const int team_shift = log2i(g * SPLIT);
  const long long per_block = NTHREADS >> team_shift;
  const long long blocks = (teams + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_bwd_kernel<T, SPLIT, VEC><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(value), loc, aw, gout, gvalue, gloc, gaw, lv, b,
      s, m, d, lq, nlevels, npoints, team_shift, g, teams);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch_split(const void* value, const float* loc,
                           const float* aw, const float* gout, float* gvalue,
                           float* gloc, float* gaw, const Levels& lv, int b,
                           int s, int m, int d, int lq, int nlevels,
                           int npoints, cudaStream_t stream) {
  const int g = group_lanes(d);
  const int split = pick_split((long long)b * lq * m, g);
#define MSDA_SPLIT(N)                                                    \
  if (split == N)                                                        \
    return launch<T, N, VEC>(value, loc, aw, gout, gvalue, gloc, gaw, lv, \
                             b, s, m, d, lq, nlevels, npoints, g, stream);
  MSDA_SPLIT(1)
  MSDA_SPLIT(2)
  MSDA_SPLIT(4)
  MSDA_SPLIT(8)
#undef MSDA_SPLIT
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* value, const float* loc, const float* aw,
                     const float* gout, float* gvalue, float* gloc,
                     float* gaw, const Levels& lv, int b, int s, int m,
                     int d, int lq, int nlevels, int npoints,
                     cudaStream_t stream) {
  // 16-byte channel loads and vector reductions: whole 8-channel groups,
  // aligned rows
  const bool vec = d % 8 == 0 && (uintptr_t)value % 16 == 0 &&
                   (uintptr_t)gout % 16 == 0 && (uintptr_t)gvalue % 16 == 0;
  if (vec)
    return dispatch_split<T, true>(value, loc, aw, gout, gvalue, gloc, gaw,
                                   lv, b, s, m, d, lq, nlevels, npoints,
                                   stream);
  return dispatch_split<T, false>(value, loc, aw, gout, gvalue, gloc, gaw,
                                  lv, b, s, m, d, lq, nlevels, npoints,
                                  stream);
}

}  // namespace

// levels: host array [nlevels][3] of (H, W, first row in S). dtype of value:
// 0 = float32, 1 = bfloat16. gvalue must be zeroed float32 [B, S, M, D].
// Returns the cudaError_t of the launch (0 on success); it does not
// synchronise.
extern "C" int fo1_msda_bwd(const void* value, const void* loc,
                            const void* aw, const void* gout, void* gvalue,
                            void* gloc, void* gaw, const int* levels, int b,
                            int s, int m, int d, int lq, int nlevels,
                            int npoints, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || m <= 0 || d <= 0 || d > 128 || lq <= 0 ||
      nlevels <= 0 || nlevels > MAX_LEVELS || npoints <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!read_levels(levels, nlevels, s, lv)) return (int)cudaErrorInvalidValue;
  const float* lf = static_cast<const float*>(loc);
  const float* af = static_cast<const float*>(aw);
  const float* gf = static_cast<const float*>(gout);
  float* gv = static_cast<float*>(gvalue);
  float* gl = static_cast<float*>(gloc);
  float* ga = static_cast<float*>(gaw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(value, lf, af, gf, gv, gl, ga, lv, b,
                                s, m, d, lq, nlevels, npoints, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(value, lf, af, gf, gv, gl, ga, lv, b,
                                        s, m, d, lq, nlevels, npoints, st);
  return (int)cudaErrorInvalidValue;
}
