// What the MSDA forward (msda.cu) and backward (msda_bwd.cu) kernels share:
// the level table, the thread map and one sample's bilinear window.
//
// Thread map. One team of T lanes (a power of two, 4 <= T <= 32, aligned
// within its warp) serves one (batch, query, head). Its G lanes of a channel
// group own 8 channels each (G = D/8 rounded up to a power of two: 4 lanes
// at D = 32, so one corner read is one 16-byte load a lane), and SPLIT such
// groups (T = G * SPLIT) take the samples in turns: group k the samples
// j = k, k + SPLIT, ... of each chunk. SPLIT > 1 fills the card when there
// are few (query, head) pairs (the UPN decoder's 900 queries), and keeps a
// team at 4 lanes or more when D < 32.
//
// Coordinates once per sample, not once per lane. For each chunk of CHUNK
// samples the team's lanes compute the windows side by side (lane t the
// samples t, t + T, ...), write them to shared memory, and after a
// __syncwarp every lane reads the ones it needs (a broadcast within the
// team).
//
// Order. The forward runs teams head-major: team = (head * B + b) * Lq + q,
// so the blocks resident at once walk neighbouring queries of one head, and
// that head's slice of the value map (5.5 MB in bf16 at the UPN encoder)
// stays in L2 while its samples read there. The backward runs the M heads
// of a query side by side (team = (b * Lq + q) * M + head): its time is in
// the float32 reductions into the coarse levels' few pixels, and there the
// 8 heads of the resident queries add into 8 different 128-byte rows of a
// pixel where head-major teams would queue on one (3.04 against 3.23 ms at
// the UPN encoder, PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msda {

constexpr int NTHREADS = 256;
constexpr int MAX_LEVELS = 16;
constexpr int CHUNK = 8;      // samples whose windows a team shares at once
constexpr int MIN_TEAM = 4;   // lanes of the smallest team
constexpr int MAX_TEAMS = NTHREADS / MIN_TEAM;
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

// Fills lv from the host array [nlevels][3] of (H, W, first row in S);
// false if a level does not fit in S.
inline bool read_levels(const int* levels, int nlevels, int s, Levels& lv) {
  lv = {};
  for (int l = 0; l < nlevels; ++l) {
    const int h = levels[3 * l], w = levels[3 * l + 1];
    const int start = levels[3 * l + 2];
    if (h <= 0 || w <= 0 || start < 0 ||
        (long long)start + (long long)h * w > s)
      return false;
    lv.h[l] = h;
    lv.w[l] = w;
    lv.start[l] = start;
  }
  return true;
}

// Lanes per channel group: 8 channels a lane, rounded up to a power of two.
inline int group_lanes(int d) {
  int g = 1;
  while (g * 8 < d) g *= 2;
  return g;
}

// Where a team sits: the (batch, query, head) it serves, head-major or the
// heads of a query side by side.
struct Team {
  int lane;        // lane in the team, 0 .. T-1
  int slot;        // team in the block
  bool active;     // false past the last (batch, query, head)
  long long gq;    // ((b * Lq) + q) * M + head: the row of loc, aw, out
  long long b;
  int head;
};

__device__ __forceinline__ Team locate(int team_shift, long long teams, int b,
                                       int lq, int m, bool head_major) {
  Team t;
  t.lane = threadIdx.x & ((1 << team_shift) - 1);
  t.slot = threadIdx.x >> team_shift;
  const long long team =
      (long long)blockIdx.x * (NTHREADS >> team_shift) + t.slot;
  t.active = team < teams;
  const long long tm = t.active ? team : 0;
  long long bq;
  if (head_major) {
    const long long per_head = (long long)b * lq;
    t.head = (int)(tm / per_head);
    bq = tm - (long long)t.head * per_head;
  } else {
    t.head = (int)(tm % m);
    bq = tm / m;
  }
  t.b = bq / lq;
  t.gq = bq * m + t.head;
  return t;
}

// One sample's 2x2 window on its level, as grid_sample(align_corners=False)
// with zeros padding: x = loc_x * W - 0.5 and y = loc_y * H - 0.5, each a
// product and a difference rounded apart (`__fmul_rn`, `__fsub_rn`), as the
// plain version's two elementwise ops: a fused multiply-add can round a
// location on a cell edge (UPN's encoder samples sit on them) into the next
// cell, where the location gradient jumps. pix: the corners' rows in S
// (00, 01, 10, 11), -1 for a corner off the map; w: the bilinear weights;
// (x0, y0): the top-left corner on the level.
// CLOSED selects the window test: the forward skips a sample whose four
// corners are all off the map (x > -1, open); the backward keeps the JAX
// `ok` mask (x >= -1, closed), where a corner with weight 0 still carries a
// location gradient. Both tests are false for NaN. Returns false for a
// skipped sample (all pix -1, all w 0).
template <bool CLOSED>
__device__ __forceinline__ bool window(float lx, float ly, int hl, int wl,
                                       int start, int (&pix)[4],
                                       float (&w)[4], float& fx, float& fy,
                                       int& x0, int& y0) {
  const float wf = (float)wl, hf = (float)hl;
  const float x = __fsub_rn(__fmul_rn(lx, wf), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, hf), 0.5f);
  const bool ok = CLOSED ? (x >= -1.f && x < wf && y >= -1.f && y < hf)
                         : (x > -1.f && x < wf && y > -1.f && y < hf);
  fx = fy = 0.f;
  x0 = y0 = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) pix[c] = -1, w[c] = 0.f;
  if (!ok) return false;
  const float x0f = floorf(x), y0f = floorf(y);
  fx = x - x0f;
  fy = y - y0f;
  x0 = (int)x0f;
  y0 = (int)y0f;
  const bool l0 = x0 >= 0, r1 = x0 + 1 < wl;
  const bool t0 = y0 >= 0, b1 = y0 + 1 < hl;
  const int p = start + y0 * wl + x0;
  pix[0] = t0 && l0 ? p : -1;
  pix[1] = t0 && r1 ? p + 1 : -1;
  pix[2] = b1 && l0 ? p + wl : -1;
  pix[3] = b1 && r1 ? p + wl + 1 : -1;
  w[0] = (1.f - fy) * (1.f - fx);
  w[1] = (1.f - fy) * fx;
  w[2] = fy * (1.f - fx);
  w[3] = fy * fx;
  return true;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 channels from p into v as float32. VEC: one 16-byte load (bf16) or two
// (f32), p 16-byte aligned; else n (<= 8, may be <= 0) scalar loads, the
// rest 0.
template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n,
                                      float (&v)[8]) {
  if (VEC) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(q[k] << 16);
      v[2 * k + 1] = __uint_as_float(q[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < n ? to_f(p[k]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load8(const float* p, int n, float (&v)[8]) {
  if (VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < n ? p[k] : 0.f;
  }
}

// 4 channels from p into v[0..3] as float32 (p 8-byte aligned for bf16,
// 16-byte aligned for f32)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

// The team size and launch for b * lq * m teams: SPLIT is the kernel's
// template argument, chosen by pick_split.
inline int pick_split(long long teams, int g) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long full = (long long)sms * 2048;  // resident threads
  int split = 1;
  while (g * split < MIN_TEAM) split *= 2;
  while (split < CHUNK && g * split < 32 && teams * g * split < full)
    split *= 2;
  return split;
}

inline int log2i(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

}  // namespace msda
