// Flash attention forward for Hopper (sm_90a): bf16 products on the tensor
// cores, fp32 online softmax.
//
// Replaces the Pallas TPU kernel vlm_fo1_tpu/ops/flash_attention.py
// (`flash_attention`, kernel `_kernel`): same semantics -- q [B,H,Sq,D],
// k/v [B,Hkv,Sk,D], GQA (query head h reads kv head h / (H/Hkv)), optional
// bottom-right-aligned causal mask, a `kv_len` bound and an optional per-key
// validity mask -- computed with fp32 logits times `scale`, an fp32 running
// max and sum, and an fp32 accumulator.
//
// What bounds it on the card: the two products are O(Sq*Sk*D) work against
// O((Sq+Sk)*D) bytes, so at the main-path shapes (ViT S=6912 D=80, trunk
// prefill S~1.7k D=128) the bound is the tensor cores' bf16 rate. Beside
// the products, every score costs an exponential on the special-function
// units (16 per SM per clock) and a few ALU instructions; at D=80 that work
// is as large as the products', so issue slots and latency, not the tensor
// cores, set the pace.
//
// bf16 inputs (`flash_bf16_kernel`), the FlashAttention-2 design on
// `mma.sync.m16n8k16`:
// - One block of 4 warps per (query tile, batch*head). At d <= 80 each warp
//   owns two 16-row m-tiles (128 query rows a block, 2 blocks per SM), so
//   every K and V fragment read from shared memory feeds two products: with
//   one m-tile the fragment reads alone took about 0.5 ms of shared-memory
//   bandwidth at the ViT shape. At d = 128 registers allow one m-tile (64
//   rows, 2 blocks per SM). Q fragments stay in registers (`ldmatrix` once);
//   the block loops over 64-key tiles of K and V.
// - S = Q K^T and O += P V both run on the tensor cores in bf16 with fp32
//   accumulation. P stays in registers between them: the S accumulator's
//   fragment layout is the A-operand layout of the next product, so P is
//   cast to bf16 (as the plain version does) and packed in place. V enters
//   as the B operand through `ldmatrix.trans`.
// - K/V tiles arrive through a two-stage ring of 16-byte `cp.async` copies,
//   zero-filled past Sk and past d (a zero K or V row keeps 0 x garbage out
//   of the sums): one barrier per tile publishes tile t and frees tile t-1's
//   stage for tile t+1, whose copies then overlap tile t's products. Each
//   thread copies a fixed column chunk of every few rows, so a copy costs a
//   pointer step. The tile's `kv_valid` bytes are staged beside it as two
//   ballot words; a tile whose bits are all set skips the per-key mask.
// - Shared rows are padded to D+8 elements: an odd number of 16-byte chunks
//   per row puts the 8 row addresses of each `ldmatrix` phase in 8 distinct
//   bank groups at every D (160-byte D=80 rows would conflict 2-way,
//   256-byte D=128 rows 8-way).
// - Head dims that are not a multiple of 8 (the tests' d=12) or rows not
//   16-byte aligned take plain element loads into the same zero-padded tile
//   (d rounds up to a multiple of 16; a zero column adds nothing to Q K^T).
// - Softmax in the log2 domain with `scale * log2(e)` folded into the
//   exponent's multiply-add and `ex2.approx.ftz`; the row max is reduced in
//   the quad of threads that share an accumulator row, the row sum kept per
//   thread and reduced once at the end. The reference max moves only when a
//   row max passes it by more than 2^8, so most tiles skip the rescale of O.
// - Masks are applied only to the tiles that need them: the tile crosses a
//   warp's causal diagonal, kv_len or Sk, or holds a key that kv_valid
//   clears. Masked keys take the finite -1e30 (a row whose keys are all
//   masked stays finite); keys past Sk take -inf, probability 0.
// - Loop bounds are the first design's: a 64-query group visits the 64-key
//   tiles below min(Sk, kv_len) and, under causal, below its first row +
//   64 + Sk - Sq, so a row with no allowed key averages the same keys as
//   before. Causal grids launch the longest query tiles first (grid.y
//   counts them down).
// A `wgmma` version (both products on warpgroup MMAs, S from shared memory,
// P from registers, unswizzled operand tiles, cp.async stages, with and
// without FA3-style overlap of softmax and P V) was right but slower at both
// main-path shapes; PERF.md keeps its numbers.
//
// f32 inputs keep the first design (`flash_f32_kernel`, fp32 FMAs from
// shared memory): tensor cores would need TF32, too coarse for the 1e-4 f32
// checks. The path is chosen by dtype alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------- f32: fp32 FMA kernel

constexpr int F_BQ = 64;
constexpr int F_BK = 64;
constexpr int F_NT = 256;

// Rows [row0, row0 + 64) of a contiguous [rows, d] matrix into shared memory
// [64][DP + 4] as fp32; rows past `rows` and columns past d are zero.
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int row0, int rows, int d) {
  constexpr int LD = DP + 4;
  const int nrows = min(64, rows - row0);
  const float* base = src + (size_t)row0 * d;
  for (int i = threadIdx.x; i < 64 * DP; i += F_NT) {
    int r = i / DP, c = i - r * DP;
    if (r >= nrows || c >= d) dst[r * LD + c] = 0.f;
  }
  const int n = nrows * d;
  for (int i = threadIdx.x; i < n; i += F_NT) {
    int r = i / d, c = i - r * d;
    dst[r * LD + c] = base[i];
  }
}

// One block of 256 threads per (batch*head, 64-query tile): each thread
// computes a 4x4 micro-tile of the 64x64 score tile (4 query rows x 4 keys
// strided by 16) from padded fp32 rows; 4 threads per query row reduce the
// tile max and sum with shuffles and own D/4 columns of its output.
template <int DP>
__global__ void __launch_bounds__(F_NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ kv_valid, float* __restrict__ o,
                 int h, int hkv, int sq, int sk, int d, int kv_len,
                 int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int LDS = F_BK + 1;
  constexpr int NG = DP / 16;  // float4 column groups per thread in P @ V
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + F_BQ * LD;
  float* vs = ks + F_BK * LD;
  float* ps = vs + F_BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int kvh = b * hkv + (bh - b * h) / (h / hkv);
  const int q0 = blockIdx.x * F_BQ;
  const float* kg = k + (size_t)kvh * sk * d;
  const float* vg = v + (size_t)kvh * sk * d;

  const int tid = threadIdx.x;
  const int sr = (tid >> 4) * 4;  // score micro-tile rows sr..sr+3
  const int sc = tid & 15;        // score micro-tile keys sc + 16*j
  const int pr = tid >> 2;        // softmax / output row
  const int pt = tid & 3;         // quarter of that row

  load_tile_f32<DP>(qs, q + (size_t)bh * sq * d, q0, sq, d);

  float m_i = NEG, l_i = 0.f;
  float acc[NG * 4];
#pragma unroll
  for (int i = 0; i < NG * 4; ++i) acc[i] = 0.f;

  int kend = min(sk, kv_len);
  if (causal) kend = min(kend, max(0, q0 + F_BQ + (sk - sq)));

  for (int kt = 0; kt < kend; kt += F_BK) {
    __syncthreads();  // previous tile's K, V and P are no longer read
    load_tile_f32<DP>(ks, kg, kt, sk, d);
    load_tile_f32<DP>(vs, vg, kt, sk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&qs[(sr + i) * LD + dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&ks[(sc + 16 * j) * LD + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qa[i].x * kb[j].x + qa[i].y * kb[j].y +
                     qa[i].z * kb[j].z + qa[i].w * kb[j].w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + sr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + sc + 16 * j;
        float val;
        if (kpos >= sk) {
          val = -INFINITY;  // past the end of the keys: probability 0
        } else {
          bool ok = kpos < kv_len;
          if (kv_valid != nullptr) ok = ok && kv_valid[kpos] != 0;
          if (causal) ok = ok && kpos <= qpos + (sk - sq);
          val = ok ? s[i][j] * scale : NEG;
        }
        ps[(sr + i) * LDS + sc + 16 * j] = val;
      }
    }
    __syncthreads();

    // online softmax over this tile: 4 threads per row, 16 keys each
    float* prow = ps + pr * LDS + pt * 16;
    float mx = -INFINITY;
#pragma unroll
    for (int x = 0; x < 16; ++x) mx = fmaxf(mx, prow[x]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      float p = expf(prow[x] - m_new);
      prow[x] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_i = alpha * l_i + sum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < NG * 4; ++i) acc[i] *= alpha;
    __syncwarp();  // the row's P was written by the 4 threads of this warp

    const float* prow_all = ps + pr * LDS;
#pragma unroll 4
    for (int j = 0; j < F_BK; ++j) {
      const float p = prow_all[j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j * LD + (pt + 4 * g) * 4]);
        acc[g * 4 + 0] += p * vv.x;
        acc[g * 4 + 1] += p * vv.y;
        acc[g * 4 + 2] += p * vv.z;
        acc[g * 4 + 3] += p * vv.w;
      }
    }
  }

  const int qrow = q0 + pr;
  if (qrow < sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    float* orow = o + ((size_t)bh * sq + qrow) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = (pt + 4 * g) * 4 + c;
        if (col < d) orow[col] = acc[g * 4 + c] * inv;
      }
    }
  }
}

// ------------------------------------------------- bf16: tensor cores

constexpr int BK = 64;       // keys per tile
constexpr int NT = 128;      // 4 warps
constexpr int NSE = BK / 2;  // score registers per thread (16 rows x BK)
constexpr int NST = 2;       // stages of the key-tile ring

// 16-row m-tiles per warp: two where registers allow (d <= 80), so each
// K and V fragment read from shared memory feeds two products
constexpr int m_tiles(int dp) { return dp <= 80 ? 2 : 1; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; `bytes` < 16
// zero-fills the rest (0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit, denormal results flushed to zero (the
// plain exp2f adds range fix-ups around the same instruction)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Where the query rows and key tiles of a block stand; the same for every
// warp of the block.
struct Geometry {
  int sq, sk, kv_len, causal;
  int off;  // causal: key kpos is allowed iff kpos <= qpos + off
  int kvl;  // min(kv_len, Sk): keys from here on are masked or past Sk
};

// kend of a 64-query group starting at row q: the key tiles the first
// design visited for it (so a row with no allowed key averages the same
// keys as before)
__device__ __forceinline__ int key_end(const Geometry& gm, int q, int rows) {
  int kend = min(gm.sk, gm.kv_len);
  if (gm.causal) kend = min(kend, max(0, q + rows + gm.off));
  return kend;
}

// Stage tile t's kv_valid as two 32-bit words, bit c of word w for key
// t * BK + 32w + c (threads 0-63, two whole warps ballot one word each);
// keys past Sk are clear.
__device__ __forceinline__ void stage_valid(uint32_t* bits,
                                            const uint8_t* kv_valid, int t,
                                            int sk) {
  const int tid = threadIdx.x;
  if (kv_valid != nullptr && tid < BK) {
    const int kpos = t * BK + tid;
    const uint32_t w =
        __ballot_sync(0xffffffffu, kpos < sk && kv_valid[kpos] != 0);
    if ((tid & 31) == 0) bits[tid >> 5] = w;
  }
}

// One warp's 16 x BK score tile in registers: element i is row
// g + 8 * ((i >> 1) & 1) and key 8 * (i >> 2) + 2 * tig + (i & 1) -- the
// accumulator layout of mma.sync m16n8 (two 8-key tiles per 16 keys).
// Masks the tile if it needs it (it crosses the causal diagonal of the
// warp's rows, kv_len or Sk, or holds a key that kv_valid clears; `bits`
// are the tile's kv_valid words, null without a mask) and returns the
// multiplier that still takes the scores to the log2 domain: 1 if they
// were masked (and scaled) here, else `sl2`.
__device__ __forceinline__ float mask_scores(float (&s)[NSE],
                                             const Geometry& gm, int kt,
                                             int qw, const uint32_t* bits,
                                             float sl2) {
  uint32_t w[2] = {~0u, ~0u};
  if (bits != nullptr) {
    w[0] = bits[0];
    w[1] = bits[1];
  }
  const bool need = (w[0] & w[1]) != ~0u || kt + BK > gm.kvl ||
                    (gm.causal && kt + BK - 1 > qw + gm.off);
  if (!need) return sl2;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < NSE; ++i) {
    const int col = (i >> 2) * 8 + tig * 2 + (i & 1);
    const int kpos = kt + col;
    const int qpos = qw + g + ((i >> 1) & 1) * 8;
    float val;
    if (kpos >= gm.sk) {
      val = -INFINITY;  // past the end of the keys: probability 0
    } else {
      bool ok = kpos < gm.kv_len && ((w[i >> 4] >> (col & 31)) & 1u);
      if (gm.causal) ok = ok && kpos <= qpos + gm.off;
      val = ok ? s[i] * sl2 : NEG;  // NEG: finite, so no row goes NaN
    }
    s[i] = val;
  }
  return 1.f;
}

// Online softmax of one score tile (scores times `mul` are in the log2
// domain): the row max is reduced over the quad of threads that share a
// row, `s` becomes exp2(s * mul - m), the reference m_r and this thread's
// part of the running sum l_r are updated, and alpha gets the factor that
// takes the accumulator's rows to the new m (1 if it stays). m moves only
// when the row max passes it by more than RESCALE_LOG2 (FlashAttention-4's
// conditional rescale): P then stays below 2^RESCALE_LOG2, which bf16 and
// the f32 sums hold as exactly as P <= 1, and most tiles skip the rescale.
constexpr float RESCALE_LOG2 = 8.f;

__device__ __forceinline__ void softmax_tile(float (&s)[NSE], float (&m_r)[2],
                                             float (&l_r)[2], float mul,
                                             float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NSE / 4; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new =
        mx * mul > m_r[r] + RESCALE_LOG2 ? mx * mul : m_r[r];
    alpha[r] = m_new == m_r[r] ? 1.f : exp2_ftz(m_r[r] - m_new);
    m_r[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NSE / 4; ++j) {
      s[4 * j + 2 * r] = exp2_ftz(fmaf(s[4 * j + 2 * r], mul, -m_new));
      s[4 * j + 2 * r + 1] = exp2_ftz(fmaf(s[4 * j + 2 * r + 1], mul, -m_new));
      sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    l_r[r] = l_r[r] * alpha[r] + sum;
  }
}

// accumulator element i is row g + 8 * ((i >> 1) & 1); skipped when no
// row of the warp moved its reference max
template <int NA>
__device__ __forceinline__ void rescale(float (&acc)[NA],
                                        const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// P as bf16 A fragments of m16n8k16:
// the two 8-key accumulator tiles 2kk and 2kk + 1 make fragment kk.
__device__ __forceinline__ void pack_p(const float (&s)[NSE],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// acc / max(l, 1e-30) into the output rows qw + g and qw + g + 8 below Sq
template <int NA>
__device__ __forceinline__ void store_rows(const float (&acc)[NA],
                                           const float (&l_r)[2],
                                           __nv_bfloat16* __restrict__ o,
                                           int bh, int sq, int d, int qw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qrow = qw + g + 8 * r;
    if (qrow >= sq) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * sq + qrow) * d;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j * 8 + tig * 2 + c;
        if (col < d) orow[col] = __float2bfloat16(acc[4 * j + 2 * r + c] * inv);
      }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// c[0..3] = a * b: the first step of a product, no zeroed accumulator
__device__ __forceinline__ void mma_bf16_first(float* c,
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Rows [row0, row0 + BK) of a contiguous [rows, d] bf16 matrix into a
// shared tile [BK][DP + 8]; rows past `rows` and columns past d are zero.
// `vec`: d % 8 == 0 and the matrix is 16-byte aligned, so each row is whole
// 16-byte chunks and goes by cp.async, each thread copying one column chunk
// of every (NT / (DP / 8))-th row; otherwise plain element loads.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int row0,
    int rows, int d, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CPR = DP / 8;   // 16-byte chunks per row
    constexpr int RPP = NT / CPR; // rows per pass
    const int tr = threadIdx.x / CPR, tc = threadIdx.x - tr * CPR;
    if (tr >= RPP) return;
    const bool col_ok = tc * 8 < d;
    const bool whole = row0 + BK <= rows;  // no row of the tile past `rows`
    const __nv_bfloat16* g = src + (size_t)(row0 + tr) * d + tc * 8;
    __nv_bfloat16* sp = dst + tr * LD + tc * 8;
#pragma unroll
    for (int p = 0; p < (BK + RPP - 1) / RPP; ++p) {
      const int r = tr + p * RPP;
      if (BK % RPP != 0 && r >= BK) break;
      const bool ok = col_ok && (whole || row0 + r < rows);
      cp_async16(sp + p * RPP * LD, ok ? g + (size_t)p * RPP * d : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BK * DP; i += NT) {
      const int r = i / DP, c = i - r * DP;
      __nv_bfloat16 x = __float2bfloat16(0.f);
      if (row0 + r < rows && c < d) x = src[(size_t)(row0 + r) * d + c];
      dst[r * LD + c] = x;
    }
  }
}

// One block of 4 warps per (64 * MT query rows, batch*head); warp w owns
// rows [16 MT w, 16 MT (w + 1)) as MT m-tiles of 16, all in one 64-query
// group. Key tiles pass through a ring of NST stages, NST - 1 tiles ahead,
// so one barrier per tile both publishes tile t and frees tile t - 1's
// stage for tile t + NST - 1. Q enters through the last stage and stays in
// registers.
template <int DP, int MT>
__global__ void __launch_bounds__(NT, 2)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const uint8_t* __restrict__ kv_valid,
                  __nv_bfloat16* __restrict__ o, int h, int hkv, int sq,
                  int sk, int d, int kv_len, int causal, float scale,
                  int vec) {
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;  // 16-wide steps of the head dim
  constexpr int NA = DP / 2;   // O accumulator registers per m-tile
  constexpr int BQ = 64 * MT;  // query rows per block
  static_assert(BQ <= 2 * BK, "Q enters through one stage");
  extern __shared__ float4 smem4[];
  // [NST][K, V][BK][LD], then the kv_valid words [NST][2]
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem4);
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(kv + NST * 2 * BK * LD);
  __nv_bfloat16* qs = kv + (NST - 1) * 2 * BK * LD;

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int kvh = b * hkv + (bh - b * h) / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const __nv_bfloat16* kg = k + (size_t)kvh * sk * d;
  const __nv_bfloat16* vg = v + (size_t)kvh * sk * d;
  const Geometry gm{sq, sk, kv_len, causal, sk - sq, min(kv_len, sk)};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int qw = q0 + warp * 16 * MT;  // this warp's first query row
  const int ntiles = (key_end(gm, q0, BQ) + BK - 1) / BK;
  const int ntiles_w = (key_end(gm, qw & ~63, 64) + BK - 1) / BK;

  auto load_kv = [&](int t) {
    const int st = t % NST;
    __nv_bfloat16* kst = kv + 2 * st * BK * LD;
    load_tile_bf16<DP>(kst, kg, t * BK, sk, d, vec);
    load_tile_bf16<DP>(kst + BK * LD, vg, t * BK, sk, d, vec);
    stage_valid(bits_s + st * 2, kv_valid, t, sk);
  };

  // Q and tiles 0 .. NST - 2, one commit group each (Q with tile 0)
  const __nv_bfloat16* qg = q + (size_t)bh * sq * d;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    load_tile_bf16<DP>(qs + i * BK * LD, qg, q0 + i * BK, sq, d, vec);
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }
  cp_async_wait<NST - 2>();  // Q and tile 0
  __syncthreads();

  // this warp's Q rows as A fragments, per m-tile and 16-wide step of d
  uint32_t qf[MT][KD][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[mt][kk], qs + ((warp * MT + mt) * 16 + (lane & 15)) * LD +
                                  kk * 16 + (lane >> 4) * 8);

  const float sl2 = scale * LOG2E;
  float m_r[MT][2], l_r[MT][2];  // per m-tile: running max (log2 domain) of
  float acc[MT][NA];             // rows g, g + 8, this thread's sums, O
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_r[mt][0] = m_r[mt][1] = NEG;
    l_r[mt][0] = l_r[mt][1] = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[mt][i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NST - 2>();  // tile t has landed (later ones may not)
    __syncthreads();  // ... for every thread; tile t - 1 (and Q) is read
    if (t + NST - 1 < ntiles) load_kv(t + NST - 1);  // into t - 1's stage
    cp_async_commit();
    if (t >= ntiles_w) continue;  // past this warp's 64-query group's kend

    const int st = t % NST;
    const __nv_bfloat16* kst = kv + 2 * st * BK * LD;
    const __nv_bfloat16* vst = kst + BK * LD;

    // S = Q K^T: K rows are d-contiguous, so plain ldmatrix gives the
    // column-major B fragments of two 8-key tiles at once
    float s[MT][NSE];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, kst + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                             kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (kk == 0) {
            mma_bf16_first(s[mt] + 4 * j, qf[mt][kk], bfr[0], bfr[1]);
            mma_bf16_first(s[mt] + 4 * j + 4, qf[mt][kk], bfr[2], bfr[3]);
          } else {
            mma_bf16(s[mt] + 4 * j, qf[mt][kk], bfr[0], bfr[1]);
            mma_bf16(s[mt] + 4 * j + 4, qf[mt][kk], bfr[2], bfr[3]);
          }
        }
      }

    uint32_t pa[MT][BK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float mul = mask_scores(
          s[mt], gm, t * BK, qw + 16 * mt,
          kv_valid != nullptr ? bits_s + st * 2 : nullptr, sl2);
      float alpha[2];
      softmax_tile(s[mt], m_r[mt], l_r[mt], mul, alpha);
      rescale(acc[mt], alpha);
      pack_p(s[mt], pa[mt]);
    }

    // O += P V: ldmatrix.trans turns V's key-major rows into B fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, vst + (kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * LD +
                                   j * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt] + 4 * j, pa[mt][kk], bfr[0], bfr[1]);
          mma_bf16(acc[mt] + 4 * j + 4, pa[mt][kk], bfr[2], bfr[3]);
        }
      }
  }
  cp_async_wait<0>();  // nothing in flight at exit
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows(acc[mt], l_r[mt], o, bh, sq, d, qw + 16 * mt);
}

// ------------------------------------------------------------ launches

// cudaFuncSetAttribute once per kernel instance and device, not per launch:
// `done` is the calling instance's own record of the devices it has set
template <typename K>
cudaError_t allow_smem(K kern, size_t smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const uint8_t* kv_valid, void* o, int b, int h, int hkv,
                       int sq, int sk, int d, int kv_len, int causal,
                       float scale, cudaStream_t stream) {
  constexpr int LD = DP + 4;
  const size_t smem =
      sizeof(float) * (size_t)(F_BQ * LD + 2 * F_BK * LD + F_BQ * (F_BK + 1));
  auto kern = flash_f32_kernel<DP>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(kern, smem, done);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + F_BQ - 1) / F_BQ, b * h);
  kern<<<grid, F_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_valid, static_cast<float*>(o), h, hkv,
      sq, sk, d, kv_len, causal, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const uint8_t* kv_valid, void* o, int b, int h,
                        int hkv, int sq, int sk, int d, int kv_len, int causal,
                        float scale, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  constexpr int MT = m_tiles(DP);
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)NST * 2 * BK * LD + NST * 8;
  auto kern = flash_bf16_kernel<DP, MT>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(kern, smem, done);
  if (err != cudaSuccess) return err;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int vec = (d % 8 == 0 && aligned) ? 1 : 0;
  dim3 grid(b * h, (sq + 64 * MT - 1) / (64 * MT));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_valid,
      static_cast<__nv_bfloat16*>(o), h, hkv, sq, sk, d, kv_len, causal,
      scale, vec);
  return cudaGetLastError();
}

#define FA_DISPATCH(LAUNCH)                                                  \
  FA_CASE(LAUNCH, 16)                                                        \
  FA_CASE(LAUNCH, 32)                                                        \
  FA_CASE(LAUNCH, 64)                                                        \
  FA_CASE(LAUNCH, 80)                                                        \
  FA_CASE(LAUNCH, 128)
#define FA_CASE(LAUNCH, DP)                                                  \
  if (d <= DP)                                                               \
    return LAUNCH<DP>(q, k, v, kv_valid, o, b, h, hkv, sq, sk, d, kv_len,    \
                      causal, scale, stream);

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const uint8_t* kv_valid, void* o, int b, int h,
                         int hkv, int sq, int sk, int d, int kv_len,
                         int causal, float scale, cudaStream_t stream) {
  FA_DISPATCH(launch_f32)
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          const uint8_t* kv_valid, void* o, int b, int h,
                          int hkv, int sq, int sk, int d, int kv_len,
                          int causal, float scale, cudaStream_t stream) {
  FA_DISPATCH(launch_bf16)
  return cudaErrorInvalidValue;
}
#undef FA_CASE
#undef FA_DISPATCH

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_valid may be null. Returns the
// cudaError_t of the launch (0 on success); the launch does not synchronise.
extern "C" int fo1_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* kv_valid,
                                       void* o, int b, int h, int hkv, int sq,
                                       int sk, int d, int kv_len, int causal,
                                       float scale, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || d <= 0 || d > 128 ||
      sq <= 0 || sk <= 0 || (sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const uint8_t* valid = static_cast<const uint8_t*>(kv_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, valid, o, b, h, hkv, sq, sk, d, kv_len,
                             causal, scale, s);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, valid, o, b, h, hkv, sq, sk, d, kv_len,
                              causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
