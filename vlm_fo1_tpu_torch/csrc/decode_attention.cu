// Decode attention for Hopper (sm_90a): one query token a row over the whole
// KV cache as stored, in three launches, with no atomics, so the result is
// the same on every run.
//
// Replaces no Pallas kernel: the JAX package leaves the decode step's
// attention (vlm_fo1_tpu/models/llm.py:164-181) to XLA, which feeds the bf16
// cache to its dots with f32 accumulation. The port's plain version widened
// the whole cache to f32 and cloned it into the batched products' layouts in
// every layer of every step (about 6x the cache's bytes, ~14 launches a
// layer). This kernel computes the same function in the same order:
// f32 dot products of q and K as stored, times `scale`; finfo(f32).min where
// the mask is False; the logits rounded to the activation dtype; an f32
// softmax; the probabilities rounded to the activation dtype; P V
// accumulated in f32 and rounded once.
//
// What bounds it on the card: a step does ~2 g FLOP a byte of cache (g query
// heads share each kv head; g = 8 in Qwen2.5-3B), far below the ~295 the
// H100 needs to be compute-bound, so the least time is reading K and V once.
// At the decode shapes (2-20 MB a layer) latency weighs as much: each
// launch ramps up and drains, and a block's loads, barriers and products
// form a chain. So the blocks are small and many (several an SM), and while
// one waits for its rows another computes; and each launch after the first
// starts while the one before drains (programmatic dependent launch), the
// P V blocks fetching V before they wait for the logits.
//
// Layout: q [B, H, hd]; k, v [B, C, Hkv, hd]; mask [B, C] bytes with a row
// stride (0 for one mask shared by every row); C is cut into pieces of 64
// slots (splits = ceil(C / 64)); scratch logits [B, H, 64 x splits] in the
// activation dtype, stats [2][B, H, splits] f32 (each piece's softmax
// (max, sum)), part [B, H, splits, hd] f32; out [B, H * hd] in the
// activation dtype. The pieces do not depend on B, and every sum over them
// (the softmax's, P V's) runs in piece order, where a piece with no valid
// slot adds an exact zero: so a row's result is the same in any batch, in a
// longer cache, and with its written slots a whole number of pieces later
// (the prompt-pad buckets are multiples of 128 slots).
//
// The launches, a block a piece:
// 1. logits: S = q K^T, scaled, masked, rounded and stored, with the
//    (max, sum of exp) of each head over the piece;
// 2. P V: each block folds every piece's (max, sum) of its heads in piece
//    order -- the probabilities are rounded after normalisation, so they
//    need the global max and sum -- then forms the rounded probabilities
//    from the stored logits and takes P V over its piece;
// 3. fold: the pieces' partial sums added in piece order and rounded.
//
// bf16 with hd 128 (Qwen2.5-3B's) and 16-byte aligned operands
// (`fast_logits`, `fast_pv`): 4 warps a block for the logits, 8 for P V. A block copies its
// K or V rows into shared memory with 16-byte cp.async (rows hd + 8 elements
// apart, so the 8 rows of an ldmatrix fall in distinct banks); `ldmatrix`
// feeds `mma.sync.m16n8k16` with f32 accumulation: A = the 16 query heads of
// a group (zero rows past it) against B = K^T for the logits, then A = the
// rounded probabilities against B = V (`ldmatrix.trans`), each warp its own
// column tiles, so no warp's sums meet another's. Masked rows are read too
// (their probability is exactly 0, and 0 x a finite cached row adds 0, as in
// the plain version), so the copies never wait for the mask; a tile or unit
// whose slots are all masked skips its products.
// Other inputs (f32, other head dims such as the tiny config's 12,
// unaligned) take `gen_logits` and
// `gen_pv`: the same phases with plain f32 FMAs, one thread a slot (logits)
// or an output column (P V).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr float FILL = -3.40282347e+38f;  // finfo(float32).min
constexpr int PIECE = 64;                 // slots a piece of C

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  long long mask_row;
  void* logits;
  float* stats;
  float* part;
  void* out;
  int b, h, hkv, c, hd;
  int splits;  // pieces of C
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back (the plain version's `.to(dtype).float()`)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A softmax (max, sum of exp(x - max)) over some logits. -inf logits (a
// masked slot rounded to bf16, or a slot past C) add nothing; a set with
// none but those is (-inf, 0).
__device__ __forceinline__ void stat_add(float& m, float& s, float r) {
  if (r == -INFINITY) return;
  if (r > m) {
    s = s * expf(m - r) + 1.f;
    m = r;
  } else {
    s += expf(r - m);
  }
}

__device__ __forceinline__ void stat_merge(float& m, float& s, float m2,
                                           float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) {
    m = mx;
    s = 0.f;
    return;
  }
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

__device__ __forceinline__ void store_stats(const Args& a, int b, int head,
                                            int i, float m, float s) {
  const size_t j = ((size_t)b * a.h + head) * a.splits + i;
  a.stats[j] = m;
  a.stats[(size_t)a.b * a.h * a.splits + j] = s;
}

// Every piece's (max, sum) of one row and head, folded by a warp into the
// softmax's (max, sum) (the same in every lane): the max over the pieces,
// which no order moves, then sum_i s_i exp(m_i - max) added in piece order.
// A piece with no valid slot is (-inf, 0) and adds an exact 0, so a row's
// result does not move when the cache grows or its written slots shift by
// whole pieces (another prompt-pad bucket).
__device__ __forceinline__ void warp_fold_stats(const Args& a, int b,
                                                int head, float& m,
                                                float& s) {
  const int lane = threadIdx.x & 31;
  const float* pm = a.stats + ((size_t)b * a.h + head) * a.splits;
  const float* ps = pm + (size_t)a.b * a.h * a.splits;
  m = -INFINITY;
  for (int i = lane; i < a.splits; i += 32) m = fmaxf(m, pm[i]);
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  s = 0.f;
  if (m == -INFINITY) return;
  for (int i0 = 0; i0 < a.splits; i0 += 32) {
    const int i = i0 + lane;
    const float t = i < a.splits ? ps[i] * expf(pm[i] - m) : 0.f;
    const int n = min(32, a.splits - i0);
    for (int j = 0; j < n; ++j) s += __shfl_sync(FULL, t, j);
  }
}

// p[0] + p[stride] + ... (n terms) in that order, 8 loads in flight at a
// time
__device__ __forceinline__ float sum_splits(const float* p, int n,
                                            int stride) {
  float s = 0.f;
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldcg(p + (size_t)(i + j) * stride);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  for (; i < n; ++i) s += __ldcg(p + (size_t)i * stride);
  return s;
}

// c[0..3] += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------- bf16, hd 128: mma.sync

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p)));
}

// Programmatic dependent launch: the next kernel on the stream may start
// once every block of this one has called `let_next_start`; it calls
// `wait_for_previous` before it reads what the previous kernel wrote (a
// no-op when launched without the attribute).
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Where a block of (row, kv head, group of 16 query heads) stands.
struct Group {
  int b, n, h0, gt;
  __device__ explicit Group(const Args& a) {
    const int groups = gridDim.y / a.hkv;
    b = blockIdx.z;
    n = blockIdx.y / groups;
    const int grp = blockIdx.y - n * groups;
    const int g = a.h / a.hkv;
    h0 = n * g + grp * 16;
    gt = min(16, g - grp * 16);
  }
};

// Rows [c0, c0 + nrows) of this kv head's K or V into shared memory, rows
// HD + 8 elements apart, by 16-byte cp.async.
template <int HD, int NT>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t kstride, int c0, int nrows) {
  constexpr int CPR = HD / 8, RS = HD + 8;
  for (int i = threadIdx.x; i < nrows * CPR; i += NT) {
    const int slot = i / CPR, ch = i - slot * CPR;
    cp_async16(dst + slot * RS + 8 * ch, src + (c0 + slot) * kstride + 8 * ch);
  }
}

// Grid (splits, Hkv x groups, B): one piece of C a block.
template <int HD>
__global__ void __launch_bounds__(THREADS) fast_logits(Args a) {
  constexpr int KS = HD / 16;  // k-steps of the product
  constexpr int RS = HD + 8;
  constexpr int LS = PIECE + 8;  // logits row stride
  __shared__ __align__(16) __nv_bfloat16 sk[PIECE * RS];
  __shared__ __align__(16) __nv_bfloat16 sl[16 * LS];
  __shared__ __align__(16) uint8_t smask[PIECE];
  let_next_start();
  const Group gr(a);
  const int piece = blockIdx.x, tid = threadIdx.x;

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, qd = lane & 3;
  const bool row0 = gid < gr.gt, row1 = gid + 8 < gr.gt;
  const size_t kstride = (size_t)a.hkv * HD;
  const int c0 = piece * PIECE, live = min(PIECE, a.c - c0);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            (size_t)gr.b * a.c * kstride + (size_t)gr.n * HD;
  copy_rows<HD, THREADS>(sk, kb, kstride, c0, live);
  const uint8_t* mrow = a.mask + (long long)gr.b * a.mask_row;
  for (int i = tid; i < PIECE; i += THREADS)
    smask[i] = i < live ? mrow[c0 + i] : 0;

  // A: query rows gid and gid + 8, k-step s = hd 16 s .. + 15
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           ((size_t)gr.b * a.h + gr.h0) * HD;
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint32_t* r0 =
        reinterpret_cast<const uint32_t*>(q + gid * HD + 16 * s + 2 * qd);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(
        q + (gid + 8) * HD + 16 * s + 2 * qd);
    qa[s][0] = row0 ? r0[0] : 0u;
    qa[s][1] = row1 ? r1[0] : 0u;
    qa[s][2] = row0 ? r0[4] : 0u;
    qa[s][3] = row1 ? r1[4] : 0u;
  }
  cp_async_wait_all();
  __syncthreads();

  const size_t cp = (size_t)PIECE * a.splits;
  __nv_bfloat16* lb = static_cast<__nv_bfloat16*>(a.logits) +
                      ((size_t)gr.b * a.h + gr.h0) * cp + c0;
  for (int t = warp; t < PIECE / 8; t += WARPS) {
    const uint2 mw = *reinterpret_cast<const uint2*>(smask + 8 * t);
    float acc[2][4] = {};  // even and odd k-steps: two shorter chains
    if (mw.x | mw.y) {
      // B: K^T, 8 slots x 32 of hd by one ldmatrix.x4 (two k-steps)
      const __nv_bfloat16* rowp =
          sk + (8 * t + (lane & 7)) * RS + 8 * (lane >> 3);
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) {
        uint32_t w[4];
        ldsm_x4(w, rowp + 32 * j);
        mma_bf16(acc[0], qa[2 * j], w[0], w[1]);
        mma_bf16(acc[1], qa[2 * j + 1], w[2], w[3]);
      }
    }
    // acc: heads gid (0, 1) and gid + 8 (2, 3) at slots 2 qd, 2 qd + 1
    const int c = 8 * t + 2 * qd;
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = c + (e & 1);
      r[e] = slot < live ? round_to<__nv_bfloat16>(
                               smask[slot] ? (acc[0][e] + acc[1][e]) * a.scale
                                           : FILL)
                         : -INFINITY;
    }
    const uint32_t w0 = pack_bf16(r[0], r[1]), w1 = pack_bf16(r[2], r[3]);
    if (row0) {
      *reinterpret_cast<uint32_t*>(sl + gid * LS + c) = w0;
      *reinterpret_cast<uint32_t*>(lb + gid * cp + c) = w0;
    }
    if (row1) {
      *reinterpret_cast<uint32_t*>(sl + (gid + 8) * LS + c) = w1;
      *reinterpret_cast<uint32_t*>(lb + (gid + 8) * cp + c) = w1;
    }
  }
  __syncthreads();
  // the piece's (max, sum) of each head, a warp a head
  for (int hh = warp; hh < gr.gt; hh += WARPS) {
    const float x0 = __bfloat162float(sl[hh * LS + lane]);
    const float x1 = __bfloat162float(sl[hh * LS + lane + 32]);
    float m = fmaxf(x0, x1);
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    float s = m == -INFINITY ? 0.f : expf(x0 - m) + expf(x1 - m);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) store_stats(a, gr.b, gr.h0 + hh, piece, m, s);
  }
}

constexpr int PV_WARPS = 8;
constexpr int PV_THREADS = 32 * PV_WARPS;

// Grid (splits, Hkv x groups, B): one piece of C a block, 8 warps, each
// warp its own column tiles (8 columns each) over every slot of the piece.
template <int HD>
__global__ void __launch_bounds__(PV_THREADS) fast_pv(Args a) {
  constexpr int RS = HD + 8;
  constexpr int LS = PIECE + 8;                        // probabilities
  constexpr int NT = HD / 8;                           // column tiles
  constexpr int TPW = (NT + PV_WARPS - 1) / PV_WARPS;  // tiles a warp
  __shared__ __align__(16) __nv_bfloat16 sv[PIECE * RS];
  __shared__ __align__(16) __nv_bfloat16 sp[16 * LS];
  __shared__ __align__(16) uint8_t smask[PIECE];
  __shared__ float gm[16], gs[16];
  const Group gr(a);
  const int split = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, qd = lane & 3;
  const size_t kstride = (size_t)a.hkv * HD;
  const int c0 = split * PIECE, live = min(PIECE, a.c - c0);

  // V rows (past C: zero, so 0 x the row adds nothing), the piece's logits
  // of the group's heads, the mask
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            (size_t)gr.b * a.c * kstride + (size_t)gr.n * HD;
  copy_rows<HD, PV_THREADS>(sv, vb, kstride, c0, live);
  for (int i = live * (HD / 8) + tid; i < PIECE * (HD / 8); i += PV_THREADS) {
    const int slot = i / (HD / 8), ch = i - slot * (HD / 8);
    *reinterpret_cast<uint4*>(sv + slot * RS + 8 * ch) = make_uint4(0, 0, 0, 0);
  }
  const uint8_t* mrow = a.mask + (long long)gr.b * a.mask_row;
  for (int i = tid; i < PIECE; i += PV_THREADS)
    smask[i] = i < live ? mrow[c0 + i] : 0;
  let_next_start();
  // V is the cache as the step left it; the logits and stats are the
  // previous launch's
  wait_for_previous();
  const size_t cp = (size_t)PIECE * a.splits;
  const __nv_bfloat16* lb = static_cast<const __nv_bfloat16*>(a.logits) +
                            ((size_t)gr.b * a.h + gr.h0) * cp + c0;
  for (int i = tid; i < gr.gt * (PIECE / 8); i += PV_THREADS) {
    const int hh = i / (PIECE / 8), j = i - hh * (PIECE / 8);
    cp_async16(sp + hh * LS + 8 * j, lb + hh * cp + 8 * j);
  }
  // every piece's (max, sum) of the group's heads, a warp a head
  for (int hh = warp; hh < gr.gt; hh += PV_WARPS) {
    float m, s;
    warp_fold_stats(a, gr.b, gr.h0 + hh, m, s);
    if (lane == 0) {
      gm[hh] = m;
      gs[hh] = s;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // the probabilities in place of the logits, rounded after normalisation
  // (0 past C, where no logit was written)
  for (int i = tid; i < gr.gt * PIECE; i += PV_THREADS) {
    const int hh = i / PIECE, j = i - hh * PIECE;
    __nv_bfloat16* x = sp + hh * LS + j;
    *x = __float2bfloat16_rn(
        j < live ? expf(__bfloat162float(*x) - gm[hh]) / gs[hh] : 0.f);
  }
  __syncthreads();

  float acc[TPW][4] = {};
  for (int u = 0; u < PIECE / 16; ++u) {
    const uint4 mw = *reinterpret_cast<const uint4*>(smask + 16 * u);
    if (!(mw.x | mw.y | mw.z | mw.w)) continue;  // every probability 0
    // A: 16 heads x 16 slots; B: 16 slots x 8 columns, transposed
    uint32_t pa[4];
    ldsm_x4(pa, sp + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LS + 16 * u +
                    8 * (lane >> 4));
    const __nv_bfloat16* vrow = sv + (16 * u + (lane & 15)) * RS;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int nt = warp + PV_WARPS * i;
      if (nt >= NT) break;
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, vrow + 8 * nt);
      mma_bf16(acc[i], pa, b0, b1);
    }
  }
  // acc[i]: heads gid (0, 1) and gid + 8 (2, 3) at columns 8 nt + 2 qd, + 1
  float* part =
      a.part + (((size_t)gr.b * a.h + gr.h0) * a.splits + split) * HD;
  const size_t hstride = (size_t)a.splits * HD;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int nt = warp + PV_WARPS * i;
    if (nt >= NT) break;
    const int d = 8 * nt + 2 * qd;
    if (gid < gr.gt)
      *reinterpret_cast<float2*>(part + gid * hstride + d) =
          make_float2(acc[i][0], acc[i][1]);
    if (gid + 8 < gr.gt)
      *reinterpret_cast<float2*>(part + (gid + 8) * hstride + d) =
          make_float2(acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------- any other input: f32 FMAs

template <typename T>
__global__ void __launch_bounds__(THREADS) gen_logits(Args a) {
  const int split = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int n = head / (a.h / a.hkv);
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.h + head) * a.hd;
  const size_t kstride = (size_t)a.hkv * a.hd;
  const T* kb = static_cast<const T*>(a.k) + (size_t)b * a.c * kstride +
                (size_t)n * a.hd;
  const uint8_t* mrow = a.mask + (long long)b * a.mask_row;
  T* lrow = static_cast<T*>(a.logits) +
            ((size_t)b * a.h + head) * ((size_t)PIECE * a.splits);
  const int c0 = split * PIECE;
  float m = -INFINITY, s = 0.f;
  for (int i = threadIdx.x; i < PIECE; i += THREADS) {
    const int c = c0 + i;
    float r = -INFINITY;
    if (c < a.c) {
      float l = FILL;
      if (mrow[c]) {
        const T* kr = kb + c * kstride;
        float acc = 0.f;
        for (int d = 0; d < a.hd; ++d)
          acc = fmaf(to_f(q[d]), to_f(kr[d]), acc);
        l = acc * a.scale;
      }
      r = round_to<T>(l);
    }
    lrow[c] = from_f<T>(r);
    stat_add(m, s, r);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    stat_merge(m, s, __shfl_xor_sync(FULL, m, o), __shfl_xor_sync(FULL, s, o));
  __shared__ float wm[WARPS], ws[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) stat_merge(wm[0], ws[0], wm[w], ws[w]);
    store_stats(a, b, head, split, wm[0], ws[0]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gen_pv(Args a) {
  constexpr int CHUNK = 2 * THREADS;
  const int split = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int n = head / (a.h / a.hkv);
  const size_t kstride = (size_t)a.hkv * a.hd;
  const T* vb = static_cast<const T*>(a.v) + (size_t)b * a.c * kstride +
                (size_t)n * a.hd;
  const T* lrow = static_cast<const T*>(a.logits) +
                  ((size_t)b * a.h + head) * ((size_t)PIECE * a.splits);
  const int c0 = split * PIECE;
  __shared__ float mx, sum, p[CHUNK];
  if (threadIdx.x < 32) {
    float m, s;
    warp_fold_stats(a, b, head, m, s);
    if (threadIdx.x == 0) {
      mx = m;
      sum = s;
    }
  }
  __syncthreads();
  float acc0 = 0.f, acc1 = 0.f;
  const int d0 = threadIdx.x, d1 = threadIdx.x + THREADS;
  for (int i0 = 0; i0 < PIECE; i0 += CHUNK) {
    for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
      const int c = c0 + i0 + i;
      p[i] = i0 + i < PIECE && c < a.c
                 ? round_to<T>(expf(to_f(lrow[c]) - mx) / sum)
                 : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < CHUNK; ++i) {
      const float pi = p[i];
      if (pi == 0.f) continue;  // 0 x a finite V adds nothing
      const T* vr = vb + (size_t)(c0 + i0 + i) * kstride;
      if (d0 < a.hd) acc0 = fmaf(pi, to_f(vr[d0]), acc0);
      if (d1 < a.hd) acc1 = fmaf(pi, to_f(vr[d1]), acc1);
    }
    __syncthreads();
  }
  float* out = a.part + (((size_t)b * a.h + head) * a.splits + split) * a.hd;
  if (d0 < a.hd) out[d0] = acc0;
  if (d1 < a.hd) out[d1] = acc1;
}

// ------------------------------------------------- the splits, in order

// Grid B x H: each output column adds its splits' partial sums in split
// order and rounds once.
template <typename T>
__global__ void fold_splits(Args a) {
  wait_for_previous();
  const size_t bh = blockIdx.x;
  for (int d = threadIdx.x; d < a.hd; d += blockDim.x)
    static_cast<T*>(a.out)[bh * a.hd + d] =
        from_f<T>(sum_splits(a.part + bh * a.splits * a.hd + d, a.splits,
                             a.hd));
}

// ------------------------------------------------------------ launches

// A launch that may start while the previous kernel on the stream runs
// (programmatic dependent launch; the kernel waits for it before reading
// its results).
template <typename K>
cudaError_t launch_after(K kern, dim3 grid, int threads, cudaStream_t s,
                         const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

template <int HD>
cudaError_t launch_fast(const Args& a, cudaStream_t s) {
  const dim3 grid(a.splits, a.hkv * ((a.h / a.hkv + 15) / 16), a.b);
  fast_logits<HD><<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_after(fast_pv<HD>, grid, PV_THREADS, s, a);
  if (err != cudaSuccess) return err;
  return launch_after(fold_splits<__nv_bfloat16>, dim3(a.b * a.h), 128, s, a);
}

template <typename T>
cudaError_t launch_generic(const Args& a, cudaStream_t s) {
  const dim3 grid(a.splits, a.h, a.b);
  gen_logits<T><<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gen_pv<T><<<grid, THREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_splits<T><<<a.b * a.h, 128, 0, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// splits = ceil(C / 64): logits B x H x 64 splits elements, stats
// 2 x B x H x splits floats, part B x H x splits x hd floats.
extern "C" int fo1_decode_attention(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    long long mask_row, void* logits,
                                    void* stats, void* part, void* out, int b,
                                    int h, int hkv, int c, int hd, float scale,
                                    int dtype, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || h > 65535 || hkv <= 0 ||
      h % hkv != 0 || c <= 0 || hd <= 0 || hd > 256)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const uint8_t*>(mask), mask_row, logits,
               static_cast<float*>(stats), static_cast<float*>(part), out,
               b, h, hkv, c, hd, (c + PIECE - 1) / PIECE, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128 && aligned16(q) && aligned16(k) &&
      aligned16(v))
    return (int)launch_fast<128>(a, s);
  if (dtype == 1) return (int)launch_generic<__nv_bfloat16>(a, s);
  if (dtype == 0) return (int)launch_generic<float>(a, s);
  return (int)cudaErrorInvalidValue;
}
