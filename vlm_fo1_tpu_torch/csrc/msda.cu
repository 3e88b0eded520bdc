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
// What bounds it on the card. The function streams ~300 MB once at the UPN
// encoder's shape (Lq = S = 85,932, M = 8, L = 5, P = 4, D = 32: 0.089 ms at
// 3.35 TB/s), but it gathers 4 corners x 64 bytes for each of 13.75 M
// samples, ~3.5 GB served by L2 and L1: the gather, and the instructions
// that address it, set the time. The earlier design (one warp per
// (batch, query, head), lane = channel) spent most of them on coordinate
// arithmetic that all 32 lanes repeated, and had little independent work
// per lane between dependent loads.
//
// Design (the thread map, windows and order of msda_common.cuh): a team of
// 4 lanes per (batch, query, head) at D = 32, 8 channels a lane, so a
// corner read is one 16-byte load; each sample's window computed once per
// team and shared through shared memory; a chunk of 8 samples unrolled, so
// a lane has up to 32 corner loads in flight; teams head-major, so one
// head's 5.5 MB slice of the bf16 value map stays in L2. At the decoder
// (7,200 (query, head) pairs) up to 8 channel groups split the samples and
// a shuffle reduction sums them. Accumulation is fp32; each corner's
// weight is the attention weight times the bilinear weight.

#include "msda_common.cuh"

namespace {

using namespace msda;

// one sample's window as the forward reads it: corner rows and weights
// (attention weight x bilinear weight)
struct __align__(16) FwdSample {
  int pix[4];
  float w[4];
};

template <typename T, int SPLIT, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, float* __restrict__ out,
                Levels lv, int b, int s, int m, int d, int lq, int nlevels,
                int npoints, int team_shift, int g, long long teams) {
  __shared__ FwdSample shared[MAX_TEAMS * CHUNK];
  const Team t = locate(team_shift, teams, b, lq, m, true);
  const int tsize = 1 << team_shift;
  const int ci = t.lane & (g - 1);   // channel group lane
  const int k = t.lane / g;          // which of the SPLIT groups
  const int c0 = ci * 8;
  const int nch = d - c0;            // channels this lane holds (> 8: 8)
  const int lp = nlevels * npoints;
  const float* loc_g = loc + t.gq * lp * 2;
  const float* aw_g = aw + t.gq * lp;
  const size_t row = (size_t)m * d;  // elements between neighbouring pixels
  const T* val_b = value + (size_t)t.b * s * row + (size_t)t.head * d + c0;
  FwdSample* sh = shared + t.slot * CHUNK;

  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;

  for (int i0 = 0; i0 < lp; i0 += CHUNK) {
    for (int j = t.lane; j < CHUNK; j += tsize) {
      const int i = i0 + j;
      FwdSample smp;
      float wb[4], fx, fy;
      int x0, y0;
      if (t.active && i < lp) {
        const int l = i / npoints;
        window<false>(loc_g[2 * i], loc_g[2 * i + 1], lv.h[l], lv.w[l],
                      lv.start[l], smp.pix, wb, fx, fy, x0, y0);
        const float a = aw_g[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) smp.w[c] = a * wb[c];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) smp.pix[c] = -1, smp.w[c] = 0.f;
      }
      sh[j] = smp;
    }
    __syncwarp();
    const int n = min(CHUNK, lp - i0);
#pragma unroll
    for (int jj = 0; jj < CHUNK / SPLIT; ++jj) {
      const int j = jj * SPLIT + k;
      if (j < n && nch > 0) {
        const FwdSample smp = sh[j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (smp.pix[c] >= 0) {
            float v[8];
            load8<VEC>(val_b + (size_t)smp.pix[c] * row, nch, v);
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[q] += smp.w[c] * v[q];
          }
        }
      }
    }
    __syncwarp();
  }
  // sum the SPLIT groups' partial sums (lanes g, 2g, ... apart in the team)
  for (int off = g; off < tsize; off <<= 1) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] += __shfl_xor_sync(FULL, acc[q], off);
  }
  if (!t.active || k != 0 || nch <= 0) return;
  float* o = out + t.gq * d + c0;
  if (VEC) {
    reinterpret_cast<float4*>(o)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < nch) o[q] = acc[q];
  }
}

template <typename T, int SPLIT, bool VEC>
cudaError_t launch(const void* value, const float* loc, const float* aw,
                   float* out, const Levels& lv, int b, int s, int m, int d,
                   int lq, int nlevels, int npoints, int g,
                   cudaStream_t stream) {
  const long long teams = (long long)b * lq * m;
  const int team_shift = log2i(g * SPLIT);
  const long long per_block = NTHREADS >> team_shift;
  const long long blocks = (teams + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_fwd_kernel<T, SPLIT, VEC><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(value), loc, aw, out, lv, b, s, m, d, lq, nlevels,
      npoints, team_shift, g, teams);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch_split(const void* value, const float* loc,
                           const float* aw, float* out, const Levels& lv,
                           int b, int s, int m, int d, int lq, int nlevels,
                           int npoints, cudaStream_t stream) {
  const int g = group_lanes(d);
  const int split = pick_split((long long)b * lq * m, g);
#define MSDA_SPLIT(N)                                                       \
  if (split == N)                                                           \
    return launch<T, N, VEC>(value, loc, aw, out, lv, b, s, m, d, lq,       \
                             nlevels, npoints, g, stream);
  MSDA_SPLIT(1)
  MSDA_SPLIT(2)
  MSDA_SPLIT(4)
  MSDA_SPLIT(8)
#undef MSDA_SPLIT
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* value, const float* loc, const float* aw,
                     float* out, const Levels& lv, int b, int s, int m, int d,
                     int lq, int nlevels, int npoints, cudaStream_t stream) {
  // 16-byte channel loads and stores: whole 8-channel groups, aligned rows
  const bool vec = d % 8 == 0 && (uintptr_t)value % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (vec)
    return dispatch_split<T, true>(value, loc, aw, out, lv, b, s, m, d, lq,
                                   nlevels, npoints, stream);
  return dispatch_split<T, false>(value, loc, aw, out, lv, b, s, m, d, lq,
                                  nlevels, npoints, stream);
}

}  // namespace

// levels: host array [nlevels][3] of (H, W, first row in S). dtype of value:
// 0 = float32, 1 = bfloat16. Any D <= 128 (D a multiple of 8 takes the
// 16-byte loads). Returns the cudaError_t of the launch (0 on success); the
// launch does not synchronise.
extern "C" int fo1_msda_fwd(const void* value, const void* loc,
                            const void* aw, void* out, const int* levels,
                            int b, int s, int m, int d, int lq, int nlevels,
                            int npoints, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || m <= 0 || d <= 0 || d > 128 || lq <= 0 ||
      nlevels <= 0 || nlevels > MAX_LEVELS || npoints <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!read_levels(levels, nlevels, s, lv)) return (int)cudaErrorInvalidValue;
  const float* lf = static_cast<const float*>(loc);
  const float* af = static_cast<const float*>(aw);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(value, lf, af, of, lv, b, s, m, d, lq,
                                nlevels, npoints, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(value, lf, af, of, lv, b, s, m, d, lq,
                                        nlevels, npoints, st);
  return (int)cudaErrorInvalidValue;
}
