// Shared machinery of the int4 weight kernels (int4_matmul.cu, int4_mlp.cu,
// int4_unpack_bench.cu) for Hopper (sm_90a): products of an activation
// matrix with int4 weights stored two nibbles per byte, summed in f32,
// scaled after the sum.
//
// Two packings of a weight W [Kc, Nc] (contraction x output) into bytes P:
//   CK  (contraction halves)  P [Kc/2, Nc]: P[k, n] = W[k, n] | W[k+Kc/2, n] << 4
//   OUT (output halves)       P [Kc, Nc/2]: P[k, n] = W[k, n] | W[k, n+Nc/2] << 4
// Nibbles are signed (two's complement, [-8, 7]).
//
// Five paths:
//   skinny_kernel (M <= 8, bf16 x; every decode step): the streaming
//     route, one launch a product. Bound in theory by the packed bytes,
//     read once. Each warp streams 16-row steps of a 64-column strip with
//     8-byte register loads that skip L1, groups of steps double-buffered
//     in registers; the block's x slice sits in shared memory (cp.async);
//     the nibbles are decoded with the magic-number decode straight into
//     mma.sync m16n8k16 A fragments (the product transposed, x rows the
//     n = 8 operand), f32 sums. K is split over the blocks of a
//     thread-block cluster (at most 8; the wrapper's plan keeps the
//     clusters within what cudaOccupancyMaxActiveClusters says the card
//     holds at once); warps are summed in warp order through shared
//     memory and the cluster's blocks in rank order in rank 0, through
//     distributed shared memory, so no workspace or second launch is
//     needed. Measured on the 3B
//     shapes it runs at a quarter of the byte bound, flat from M = 1 to 8:
//     the decode, the reduction and the first round trip to memory do not
//     overlap the stream enough (PERF.md).
//   tma_kernel   (M > 8, bf16 x, shapes TMA can describe; every 3B shape):
//     wgmma fed by TMA, the product taken transposed (out^T = W^T x^T) so
//     that the weights are the A operand in registers. One warp keeps a
//     ring of 4-5 TMA stages in flight (mbarriers); a stage is 128
//     contraction slots: two 128-byte-swizzled x boxes of 128 rows x 64
//     columns (CK: columns [k0, k0+64) of each half; OUT: [k0, k0+128))
//     and the packed bytes of the tile's weight columns (64-byte swizzle).
//     2 or 4 consumer warpgroups, 64 weight columns each, load their
//     fragment bytes from the packed tile, decode them in registers with
//     the magic-number decode (decode_magic: a lop3 and a bf16x2 fma per
//     pair, no int -> float conversion) and run m64n128k16 products with
//     the x tile as B, f32 sums in registers. Persistent blocks, one per
//     SM. What bounds it on the card: the bf16 tensor-core rate at the
//     3B prefill shapes in theory; measured, the tensor pipe runs at about
//     60% of it and the x tile re-read for every column tile (x bytes
//     times the column tiles, from L2) comes next.
//   mma_kernel   (M > 8, bf16 x, other shapes: row strides that are not
//     multiples of 16 bytes, misaligned pointers): tensor-core tiles
//     (mma.sync, bf16 in, f32 sums) of 128 rows; x and the unpacked
//     weights staged in shared memory through registers.
//   gemm_kernel  (M > 8, f32 x): a 64 x 64 output tile per block of 256
//     threads, 4 x 4 outputs per thread. Each step stages 32 contraction
//     rows: x as f32 (transposed) and the weight bytes sign-extended once
//     into f32, in shared memory, then 32 FMA rounds from float4 reads.
//     Bound by the f32 FMA rate.
//   gemv_kernel  (M <= 8, f32 x): streams the packed bytes once, 4 bytes
//     per lane per row (one 32-bit load), f32 FMAs, 128 packed columns per
//     block; the 8 warps of a block take interleaved rows and the blocks
//     of one column range take consecutive row slices (blockIdx.y). Warps
//     are summed through shared memory and slices through an f32
//     workspace by finish_kernel, both in a fixed order.
// Every path sums in a fixed order, so results repeat bit for bit.
// Epilogues: SCALE  out = acc * s0[n]
//            SWIGLU out = silu(acc0 * s0[n]) * (acc1 * s1[n])  (two weights)

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace int4k {

enum { CK = 0, OUT = 1 };
enum { SCALE = 0, SWIGLU = 1 };

constexpr int NT = 256;      // threads per block, both paths
constexpr int BM = 64;       // gemm: output rows per block
constexpr int BN = 64;       // gemm: output columns per block
constexpr int KT = 32;       // gemm: contraction rows per step
constexpr int LDS = BM + 4;  // shared row stride (floats), float4 aligned
constexpr int GCOLS = 128;   // gemv: packed columns per block


// signed nibbles of byte j (0..3) of a little-endian 32-bit word
__device__ __forceinline__ float nib_lo(uint32_t w, int j) {
  return (float)((int32_t)(w << (28 - 8 * j)) >> 28);
}
__device__ __forceinline__ float nib_hi(uint32_t w, int j) {
  return (float)((int32_t)(w << (24 - 8 * j)) >> 28);
}

// Magic-number decode of one word of packed bytes b0..b3 into four bf16x2
// words, exact and without an int -> float conversion: n ^ 8 moves a signed
// nibble s to s + 8 in [0, 15]; OR-ed into the mantissa of 0x4300 (bf16
// 128.0, whose mantissa step is 1) it reads 136 + s, and one bf16x2
// multiply-add (x * 1 - 136) leaves s. The trick of FasterTransformer's and
// Marlin's int4 -> fp16 converters.
//   lo[0] = (low nibble of b0, of b1), lo[1] = (b2, b3); hi likewise with
//   the high nibbles (the low 16 bits hold the first value).
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void decode_magic(uint32_t w, uint32_t (&lo)[2],
                                             uint32_t (&hi)[2]) {
  constexpr uint32_t MASK = 0x000F000Fu, MAGIC = 0x43004300u;
  constexpr uint32_t ONE = 0x3F803F80u, MINUS136 = 0xC308C308u;
  w ^= 0x88888888u;
  const uint32_t t01 = __byte_perm(w, 0u, 0x4140);  // b0 | b1 << 16
  const uint32_t t23 = __byte_perm(w, 0u, 0x4342);  // b2 | b3 << 16
  lo[0] = bf16x2_fma((t01 & MASK) | MAGIC, ONE, MINUS136);
  lo[1] = bf16x2_fma((t23 & MASK) | MAGIC, ONE, MINUS136);
  hi[0] = bf16x2_fma(((t01 >> 4) & MASK) | MAGIC, ONE, MINUS136);
  hi[1] = bf16x2_fma(((t23 >> 4) & MASK) | MAGIC, ONE, MINUS136);
}

// the 4 bytes P[row, c0 .. c0+3] as a word; bytes past `cols` read 0
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ p, int row,
                                          int c0, int cols, bool vec) {
  const int8_t* q = p + (size_t)row * cols + c0;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(q));
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c0 + j < cols) w |= (uint32_t)(uint8_t)__ldg(q + j) << (8 * j);
  return w;
}

template <int EPI>
__device__ __forceinline__ float epilogue(float a0, float a1, const float* s0,
                                          const float* s1, int n) {
  if (EPI == SCALE) return a0 * s0[n];
  float g = a0 * s0[n], u = a1 * s1[n];
  return g * (1.f / (1.f + expf(-g))) * u;
}

// ---------------------------------------------------------------- gemm
// x [M, K] (row-major, K = Kc); W packed per MODE; out [M, N] (N = Nc).
template <int MODE, int NW, int EPI>
__global__ void __launch_bounds__(NT)
gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w0,
            const int8_t* __restrict__ w1, const float* __restrict__ s0,
            const float* __restrict__ s1, float* __restrict__ out, int M, int K,
            int N) {
  __shared__ __align__(16) float As[KT][LDS];
  __shared__ __align__(16) float Ws[NW][KT][LDS];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * BM;
  // CK: 64 output columns from 64 packed columns; OUT: 64 output columns
  // from 32 packed columns (32 low nibbles, then 32 high nibbles)
  const int pc0 = MODE == CK ? blockIdx.x * BN : blockIdx.x * (BN / 2);
  const int prow = MODE == CK ? K / 2 : K;   // packed rows
  const int pcol = MODE == CK ? N : N / 2;   // packed columns
  const int8_t* wp[2] = {w0, w1};

  float acc[NW][4][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[w][i][j] = 0.f;

  // x tile loader: thread t takes row t/4, contraction slots 8*(t%4)..+8
  const int am = t / 4, aj = (t % 4) * 8;
  // weight tile loader: 1024 bytes per step, 4 per thread
  const int wr = MODE == CK ? t / 16 : t / 8;          // packed row in step
  const int wc = MODE == CK ? (t % 16) * 4 : (t % 8) * 4;
  const int steps = MODE == CK ? (K / 2 + KT / 2 - 1) / (KT / 2)
                               : (K + KT - 1) / KT;

  for (int s = 0; s < steps; ++s) {
    // ---- stage x: slot j < 16 is contraction row k0 + j (CK: low half);
    // CK slot j >= 16 is row K/2 + k0 + j - 16 (high half)
    {
      const int m = m0 + am;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = aj + jj;
        int k;
        bool ok;
        if (MODE == CK) {
          const int kk = s * (KT / 2) + (j % 16);
          ok = kk < K / 2;
          k = j < 16 ? kk : K / 2 + kk;
        } else {
          k = s * KT + j;
          ok = k < K;
        }
        As[j][am] = (m < M && ok) ? x[(size_t)m * K + k] : 0.f;
      }
    }
    // ---- stage the weight bytes, each nibble sign-extended once
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int r = MODE == CK ? s * (KT / 2) + wr : s * KT + wr;
      const int c = pc0 + wc;
      uint32_t word = 0;
      if (r < prow) word = load4(wp[w], r, c, pcol, false);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (MODE == CK) {
          Ws[w][wr][wc + j] = nib_lo(word, j);
          Ws[w][KT / 2 + wr][wc + j] = nib_hi(word, j);
        } else {
          Ws[w][wr][wc + j] = nib_lo(word, j);
          Ws[w][wr][BN / 2 + wc + j] = nib_hi(word, j);
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KT; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float4 b = *reinterpret_cast<const float4*>(&Ws[w][k][tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[w][i][j] = fmaf(av[i], bv[j], acc[w][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      int n;
      if (MODE == CK) {
        n = pc0 + c;
        if (n >= N) continue;
      } else {
        const int p = pc0 + (c % (BN / 2));
        if (p >= N / 2) continue;
        n = c < BN / 2 ? p : N / 2 + p;
      }
      const float v = epilogue<EPI>(acc[0][i][j], acc[NW - 1][i][j], s0, s1, n);
      out[(size_t)m * N + n] = v;
    }
  }
}

// ------------------------------------------------------------ mma (bf16)
// The tiled path for bf16 x on the tensor cores: mma.sync m16n8k16 with bf16
// operands and f32 accumulators (int4 values are exact in bf16, and each
// product is exact in f32). A 128 x (128 / NW) output tile per block of 8
// warps (2 x 4, each 64 rows x 32/NW columns per weight); 32 contraction
// slots per step, laid out as in gemm_kernel. x is staged in shared memory
// as bf16 [128][40] (k contiguous, padded so the fragment loads of a warp
// hit 32 distinct banks), the weights are unpacked once per step into bf16
// [n][40]; the next step's global loads are issued before this step's MMAs.
constexpr int MB = 128;       // mma: output rows per block
constexpr int MK = 32;        // mma: contraction slots per step
constexpr int MLD = MK + 8;   // mma: shared row stride (bf16)

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int MODE, int NW, int EPI>
__global__ void __launch_bounds__(NT)
mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w0,
           const int8_t* __restrict__ w1, const float* __restrict__ s0,
           const float* __restrict__ s1, __nv_bfloat16* __restrict__ out, int M,
           int K, int N, int xvec) {
  constexpr int TBN = 128 / NW;                 // output columns per block
  constexpr int PC = MODE == CK ? TBN : TBN / 2;  // packed columns per step
  constexpr int PR = MODE == CK ? MK / 2 : MK;    // packed rows per step
  constexpr int WT = 256 / NW;                  // loader threads per weight
  constexpr int NJ = 4 / NW;                    // n8 tiles per warp
  __shared__ __align__(16) __nv_bfloat16 As[MB][MLD];
  __shared__ __align__(16) __nv_bfloat16 Bs[NW][TBN][MLD];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * MB;
  const int pc0 = blockIdx.x * PC;
  const int prow = MODE == CK ? K / 2 : K;
  const int pcol = MODE == CK ? N : N / 2;
  const int steps = (prow + PR - 1) / PR;

  // loader roles: x -- two 8-slot vectors; weights -- one packed column,
  // 8 consecutive packed rows
  const int lw = t / WT, lcol = (t % WT) % PC, lrow = ((t % WT) / PC) * 8;
  const int8_t* wsrc = lw == 0 ? w0 : w1;

  uint4 xa[2];
  uint32_t wb[2];
  auto load = [&](int s) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = t + v * NT, row = idx / 4, q = idx % 4, m = m0 + row;
      int k0, lim;
      if (MODE == CK) {
        k0 = (q < 2 ? 0 : K / 2) + s * (MK / 2) + (q % 2) * 8;
        lim = (q < 2 ? 0 : K / 2) + K / 2;
      } else {
        k0 = s * MK + q * 8;
        lim = K;
      }
      if (m < M && xvec && k0 + 8 <= lim) {
        xa[v] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k0));
      } else {
        uint32_t u[4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const size_t o = (size_t)m * K + k0 + j;
          const uint32_t lo = (m < M && k0 + j < lim) ? __bfloat16_as_ushort(x[o]) : 0u;
          const uint32_t hi = (m < M && k0 + j + 1 < lim) ? __bfloat16_as_ushort(x[o + 1]) : 0u;
          u[j / 2] = lo | (hi << 16);
        }
        xa[v] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
    const int c = pc0 + lcol;
    wb[0] = wb[1] = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = s * PR + lrow + j;
      const uint32_t b = (c < pcol && r < prow)
          ? (uint32_t)(uint8_t)__ldg(wsrc + (size_t)r * pcol + c) : 0u;
      wb[j / 4] |= b << (8 * (j % 4));
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = t + v * NT;
      *reinterpret_cast<uint4*>(&As[idx / 4][(idx % 4) * 8]) = xa[v];
    }
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      lo[j / 2] = bf16x2(nib_lo(wb[j / 4], j % 4), nib_lo(wb[j / 4], j % 4 + 1));
      hi[j / 2] = bf16x2(nib_hi(wb[j / 4], j % 4), nib_hi(wb[j / 4], j % 4 + 1));
    }
    const uint4 l4 = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    const uint4 h4 = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (MODE == CK) {
      *reinterpret_cast<uint4*>(&Bs[lw][lcol][lrow]) = l4;
      *reinterpret_cast<uint4*>(&Bs[lw][lcol][MK / 2 + lrow]) = h4;
    } else {
      *reinterpret_cast<uint4*>(&Bs[0][lcol][lrow]) = l4;
      *reinterpret_cast<uint4*>(&Bs[0][PC + lcol][lrow]) = h4;
    }
  };

  float acc[NW][4][NJ][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0.f;

  load(0);
  for (int s = 0; s < steps; ++s) {
    stage();
    __syncthreads();
    if (s + 1 < steps) load(s + 1);
#pragma unroll
    for (int ks = 0; ks < MK; ks += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + tig * 2]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + tig * 2]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 8 + tig * 2]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 8 + tig * 2]);
      }
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = wn * (TBN / 4) + j * 8 + g;
          uint32_t b[2];
          b[0] = *reinterpret_cast<const uint32_t*>(&Bs[w][n][ks + tig * 2]);
          b[1] = *reinterpret_cast<const uint32_t*>(&Bs[w][n][ks + 8 + tig * 2]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(acc[w][i][j], a[i], b);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int c = wn * (TBN / 4) + j * 8 + tig * 2 + (e % 2);
        int n;
        if (MODE == CK) {
          n = pc0 + c;
          if (n >= N) continue;
        } else {
          const int p = pc0 + (c % PC);
          if (p >= N / 2) continue;
          n = c < PC ? p : N / 2 + p;
        }
        if (m >= M) continue;
        const float v = epilogue<EPI>(acc[0][i][j][e], acc[NW - 1][i][j][e], s0, s1, n);
        out[(size_t)m * N + n] = __float2bfloat16(v);
      }
}

// ------------------------------------------------------------ tma (bf16)
// The tiled path on wgmma, fed by TMA (see the header). The product is
// computed transposed, out^T = W^T x^T: the decoded weights are wgmma's A
// operand, straight from registers, and the x tile is its B operand in
// shared memory (K-major, 128-byte swizzle, as TMA writes it). No decoded
// tile goes through shared memory.
// Block: NWG consumer warpgroups (warps 0 .. 4NWG-1) and one warp that
// issues the copies (warp 4NWG). A tile is 128 x rows by 64 NWG A rows
// (weight columns): warpgroup wg owns A rows 64wg .. 64wg+63 and all 128 x
// rows, so the warpgroups share each x tile. Shared memory, 1024-byte
// aligned: STAGES x [x lo box 16 KB | x hi box 16 KB | packed NWG x 4 KB],
// then full / empty mbarriers. The packed boxes are 64 bytes wide with
// TMA's 64-byte swizzle, so the fragment loads of a warp, 4 rows apart,
// hit distinct banks.
// A fragment of thread (warp w of its warpgroup, g = lane/4, t = lane%4)
// for k16 block kb: a0 = (row g, k 2t..2t+1), a1 = (row g+8, same k),
// a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, same k), rows counted from
// 16w. Rows map to weight columns so that one decoded word fills a pair:
//   CK SCALE: rows g, g+8 -> columns 16w+2g, 16w+2g+1 of packed box wg
//     (64 columns; one 16-bit load a contraction row);
//   CK SWIGLU: rows g, g+8 -> gate and up column 32(wg%2)+8w+g of gate
//     box wg/2 and up box NWG/2 + wg/2, so the epilogue finds both in one
//     thread;
//   OUT: rows g, g+8 -> the low and high nibble of packed column
//     32(wg%2)+8w+g of box wg/2 (64 columns x 128 rows): output columns p
//     and N/2 + p.
// A stage is 128 contraction slots: CK k16 blocks 0-3 are the low nibbles
// of its 64 packed rows (x lo box), blocks 4-7 the high nibbles (x hi box);
// OUT, its 128 packed rows (both boxes).
namespace tma {
constexpr int ROWS = 128;                      // x rows per tile
constexpr int X_BYTES = ROWS * 64 * 2;         // one x box
template <int NWG>
struct Cfg {
  static constexpr int P_BYTES = NWG * 4096;   // packed bytes per stage
  static constexpr int STAGE_BYTES = 2 * X_BYTES + P_BYTES;
  static constexpr int STAGES = NWG == 2 ? 5 : 4;
  static constexpr int NTHREADS = 128 * NWG + 32;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 16 * STAGES + 1024;
};
}  // namespace tma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// 64-bit wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define I4_ACC8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
// d += A (64 x 16, bf16 fragments in registers) * B (16 x 128, K-major in
// shared memory), f32 sums
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : I4_ACC8(0), I4_ACC8(8), I4_ACC8(16), I4_ACC8(24), I4_ACC8(32), I4_ACC8(40),
        I4_ACC8(48), I4_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef I4_ACC8

// This thread's A fragments of one stage: a[kb][0..3] for the 8 k16 blocks.
// Byte (r, c) of a 64-byte-wide packed box sits, under TMA's 64-byte
// swizzle, at r*64 + (((c/16) ^ (r/2)) % 4) * 16 + c%16; every row this
// thread reads is 16kb + 2t + {0, 1, 8, 9}, so (r/2) % 4 = t % 4 and the
// column part of the offset is the same for all of them.
template <int MODE, int EPI, int NWG>
__device__ __forceinline__ void decode_frags(const uint8_t* packed, int wg, int w, int g,
                                             int t, uint32_t (&a)[8][4]) {
  // the thread's packed column in its box, its box, and the swizzled offset
  const bool scale_ck = MODE == CK && EPI == SCALE;
  const int c = scale_ck ? 16 * w + 2 * g : 32 * (wg % 2) + 8 * w + g;
  const int box_off = scale_ck ? 4096 * wg : MODE == OUT ? 8192 * (wg / 2) : 4096 * (wg / 2);
  const uint8_t* box = packed + box_off + 128 * t + ((((c >> 4) ^ t) & 3) << 4) + (c & 15);
  constexpr int UP = 4096 * (NWG / 2);          // SWIGLU: gate box -> up box
#pragma unroll
  for (int kb = 0; kb < (MODE == CK ? 4 : 8); ++kb) {
    const uint8_t* p = box + 16 * kb * 64;   // row 16kb + 2t
    if (MODE == OUT) {
      // one column p: [P(r), P(r+1), P(r+8), P(r+9)]; low nibbles are the
      // rows of output column p (a0, a2), high nibbles those of N/2 + p
      const uint32_t b0 = p[0], b1 = p[64], b8 = p[512], b9 = p[576];
      uint32_t lo[2], hi[2];
      decode_magic(b0 | (b1 << 8) | (b8 << 16) | (b9 << 24), lo, hi);
      a[kb][0] = lo[0], a[kb][2] = lo[1], a[kb][1] = hi[0], a[kb][3] = hi[1];
    } else {
      uint32_t wd[2];                    // rows (r, r+1), then (r+8, r+9)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* q = p + 512 * h;
        if (EPI == SWIGLU) {
          // gate and up column c: [G(r0), G(r0+1), U(r0), U(r0+1)]
          wd[h] = (uint32_t)q[0] | ((uint32_t)q[64] << 8) | ((uint32_t)q[UP] << 16) |
                  ((uint32_t)q[UP + 64] << 24);
        } else {
          // columns c, c+1: [P(r0,c), P(r0+1,c), P(r0,c+1), P(r0+1,c+1)]
          const uint32_t v0 = *reinterpret_cast<const uint16_t*>(q);
          const uint32_t v1 = *reinterpret_cast<const uint16_t*>(q + 64);
          wd[h] = __byte_perm(v0, v1, 0x5140);
        }
      }
      // low nibbles: k16 block kb; high nibbles: block kb + 4
      uint32_t lo[2], hi[2];
      decode_magic(wd[0], lo, hi);
      a[kb][0] = lo[0], a[kb][1] = lo[1], a[kb + 4][0] = hi[0], a[kb + 4][1] = hi[1];
      decode_magic(wd[1], lo, hi);
      a[kb][2] = lo[0], a[kb][3] = lo[1], a[kb + 4][2] = hi[0], a[kb + 4][3] = hi[1];
    }
  }
}

// Epilogue of one tile: d[4i + e] is A row 16w + g + 8(e/2) (a weight
// column), x row 8i + 2t + e%2 of this warpgroup's 64 x 128 product.
template <int MODE, int EPI, int NWG>
__device__ __forceinline__ void tma_epilogue(const float (&d)[64], const float* s0,
                                             const float* s1, __nv_bfloat16* out, int M,
                                             int N, int m0, int ct, int wg, int w, int g,
                                             int t) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int m = m0 + 8 * i + 2 * t + e1;
      if (m >= M) continue;
      const float lo = d[4 * i + e1], hi = d[4 * i + 2 + e1];   // rows g, g+8
      __nv_bfloat16* o = out + (size_t)m * N;
      if (MODE == OUT) {
        const int p = ct * 32 * NWG + 32 * wg + 8 * w + g;
        if (p < N / 2) {
          o[p] = __float2bfloat16(lo * s0[p]);
          o[N / 2 + p] = __float2bfloat16(hi * s0[N / 2 + p]);
        }
      } else if (EPI == SWIGLU) {
        const int n = ct * 32 * NWG + 32 * wg + 8 * w + g;
        if (n < N) o[n] = __float2bfloat16(epilogue<SWIGLU>(lo, hi, s0, s1, n));
      } else {
        const int n = ct * 64 * NWG + 64 * wg + 16 * w + 2 * g;
        if (n + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(o + n) =
              __floats2bfloat162_rn(lo * s0[n], hi * s0[n + 1]);
        } else if (n < N) {
          o[n] = __float2bfloat16(lo * s0[n]);
        }
      }
    }
  }
}

// x maps: CK, the halves x[:, :K/2] and x[:, K/2:] (boxes 64 x 128); OUT,
// x itself twice. w maps (64-byte swizzle): CK, 64 x 64 boxes of the packed
// weight (SWIGLU: gate, up); OUT, 64 packed columns x 128 rows.
// Persistent: block b takes output tiles b, b + gridDim.x, ... (column
// tiles fastest, so the blocks at work share x rows in L2); the copy ring
// runs on across tiles. Each warpgroup decodes its own fragments, runs its
// products and waits for them; the warpgroups interleave, so some decode
// while the others' products run.
template <int MODE, int EPI, int NWG>
__global__ void __launch_bounds__(tma::Cfg<NWG>::NTHREADS, 1)
tma_kernel(const __grid_constant__ CUtensorMap xmap_lo,
           const __grid_constant__ CUtensorMap xmap_hi,
           const __grid_constant__ CUtensorMap wmap0,
           const __grid_constant__ CUtensorMap wmap1, const float* __restrict__ s0,
           const float* __restrict__ s1, __nv_bfloat16* __restrict__ out, int M,
           int K, int N) {
  using namespace tma;
  constexpr int STAGES = Cfg<NWG>::STAGES, STAGE_BYTES = Cfg<NWG>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // CK: 64 packed rows a stage; OUT: 128 contraction rows a stage
  const int steps = MODE == CK ? (K / 2 + 63) / 64 : (K + 127) / 128;
  // output (CK SCALE), h (SWIGLU) or packed (OUT) columns of a tile
  const int tcols = (MODE == OUT || EPI == SWIGLU) ? 32 * NWG : 64 * NWG;
  const int ncol = ((MODE == OUT ? N / 2 : N) + tcols - 1) / tcols;
  const int tiles = ncol * ((M + ROWS - 1) / ROWS);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- copies: one thread keeps the stage ring full
    if (lane == 0) {
      int j = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / ncol) * ROWS, c0 = (tile % ncol) * tcols;
        for (int it = 0; it < steps; ++it, ++j) {
          const int s = j % STAGES, use = j / STAGES;
          if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t base = smem_u32(smem + s * STAGE_BYTES);
          const uint32_t pk = base + 2 * X_BYTES;
          mbar_expect_tx(full, STAGE_BYTES);
          if (MODE == CK) {
            const int k0 = it * 64;
            tma_load(base, &xmap_lo, full, k0, m0);
            tma_load(base + X_BYTES, &xmap_hi, full, k0, m0);
            // box a: SCALE, columns c0 + 64a; SWIGLU, gate boxes then up
#pragma unroll
            for (int a = 0; a < NWG; ++a) {
              const bool up = EPI == SWIGLU && a >= NWG / 2;
              const int col = EPI == SWIGLU ? c0 + 64 * (a % (NWG / 2)) : c0 + 64 * a;
              tma_load(pk + 4096 * a, up ? &wmap1 : &wmap0, full, col, k0);
            }
          } else {
            const int k0 = it * 128;
            tma_load(base, &xmap_lo, full, k0, m0);
            tma_load(base + X_BYTES, &xmap_hi, full, k0 + 64, m0);
#pragma unroll
            for (int a = 0; a < NWG / 2; ++a)
              tma_load(pk + 8192 * a, &wmap0, full, c0 + 64 * a, k0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers
  const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  int j = 0;                                    // stage counter over all tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int ks = 0; ks < steps; ++ks, ++j) {
      const int s = j % STAGES;
      const uint8_t* st = smem + s * STAGE_BYTES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      uint32_t a[8][4];
      decode_frags<MODE, EPI, NWG>(st + 2 * X_BYTES, wg, w, g, t, a);
      const uint32_t xb = smem_u32(st);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kb = 0; kb < 8; ++kb)
        wgmma_rs_m64n128k16(d, a[kb],
                            gmma_desc(xb + (kb / 4) * X_BYTES + (kb % 4) * 32, 16, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      // stage s is spent: its x boxes read by the products, its packed
      // bytes decoded before them
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    fence_acc(d);
    tma_epilogue<MODE, EPI, NWG>(d, s0, s1, out, M, N, (tile / ncol) * ROWS, tile % ncol,
                                 wg, w, g, t);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_acc(d);
  }
}

// ---------------------------------------------------------------- gemv
// Partial sums of rows [blockIdx.y * rows_per, ...) of the packed weight into
// part[((split * NW + w) * M + m) * N + n], f32, unscaled.
template <int MODE, int NW, int MT>
__global__ void __launch_bounds__(NT)
gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ w0,
            const int8_t* __restrict__ w1, float* __restrict__ part, int M,
            int K, int N, int rows_per, int vec) {
  constexpr int OPT = MODE == CK ? 4 : 8;   // outputs per lane per weight
  constexpr int E = NW * OPT * 32;          // outputs per warp
  __shared__ float red[NT / 32][E];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int prow = MODE == CK ? K / 2 : K;
  const int pcol = MODE == CK ? N : N / 2;
  const int c0 = blockIdx.x * GCOLS + lane * 4;
  const int r0 = blockIdx.y * rows_per;
  const int r1 = min(prow, r0 + rows_per);
  const int8_t* wp[2] = {w0, w1};
  const bool live = c0 < pcol;

  float acc[NW][MT][OPT];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int o = 0; o < OPT; ++o) acc[w][m][o] = 0.f;

  for (int r = r0 + warp; r < r1; r += 4 * (NT / 32)) {
    uint32_t word[NW][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int rr = r + u * (NT / 32);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        word[w][u] = (live && rr < r1) ? load4(wp[w], rr, c0, pcol, vec) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int rr = r + u * (NT / 32);
      if (rr >= r1) break;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
        if (MODE == CK) {
          const float xl = x[(size_t)m * K + rr];
          const float xh = x[(size_t)m * K + K / 2 + rr];
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[w][m][j] = fmaf(xh, nib_hi(word[w][u], j),
                                  fmaf(xl, nib_lo(word[w][u], j), acc[w][m][j]));
        } else {
          const float xv = x[(size_t)m * K + rr];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[0][m][j] = fmaf(xv, nib_lo(word[0][u], j), acc[0][m][j]);
            acc[0][m][4 + j] = fmaf(xv, nib_hi(word[0][u], j), acc[0][m][4 + j]);
          }
        }
      }
    }
  }

  // warps -> block, in warp order; one output per thread
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int o = 0; o < OPT; ++o) red[warp][(w * OPT + o) * 32 + lane] = acc[w][m][o];
    __syncthreads();
    const int e = threadIdx.x;
    if (e < E) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < NT / 32; ++q) v += red[q][e];
      const int w = e / (OPT * 32), o = (e / 32) % OPT, l = e % 32;
      const int p = blockIdx.x * GCOLS + l * 4 + (o % 4);
      if (p < pcol) {
        const int n = (MODE == OUT && o >= 4) ? N / 2 + p : p;
        part[(((size_t)blockIdx.y * NW + w) * M + m) * N + n] = v;
      }
    }
    __syncthreads();
  }
}

// slices -> result: sum the `splits` partials of each output in order, then
// the epilogue
template <int NW, int EPI>
__global__ void __launch_bounds__(NT)
finish_kernel(const float* __restrict__ part, const float* __restrict__ s0,
              const float* __restrict__ s1, float* __restrict__ out, int M, int N,
              int splits) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= M * N) return;
  const int m = idx / N, n = idx % N;
  float a[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[(((size_t)s * NW + w) * M + m) * N + n];
    a[w] = v;
  }
  out[idx] = epilogue<EPI>(a[0], a[NW - 1], s0, s1, n);
}

// ------------------------------------------------------ skinny (bf16 x)
// The streaming route for bf16 x and M <= 8 (see the header), one launch a
// product. The product is taken transposed, out^T = W^T x^T, on
// mma.sync.m16n8k16: the decoded weights are the A operand (16 weight
// columns x 16 contraction slots), the <= 8 rows of x the n = 8 B operand
// (rows past M read zeros), f32 sums.
//
// Grid (S, units), clusters of S blocks along x. A unit is 64 packed
// columns; block `rank` of its cluster takes packed rows [rank * rows_per,
// ...) (rows_per a multiple of 16, from the wrapper's plan). Its 8 warps
// take the 16-row steps of that slice in turn (warp w: steps w, w + 8, ...).
// In a step, thread (g = lane/4, t = lane%4) loads 8 bytes (its columns
// 8g .. 8g+7) of packed rows 2t, 2t+1, 2t+8, 2t+9 -- the rows of its A
// fragments -- straight into registers with 8-byte loads that skip L1; one
// load instruction of a warp covers four whole 64-byte row segments.
// Groups of PF steps are double-buffered in registers, so the next group's
// bytes are in flight while this one is decoded and multiplied. The x
// slice of the block ([8, 2 rows_per] CK, [8, rows_per] OUT, bf16) is
// staged once in shared memory (cp.async, issued before the weights), its
// row stride padded so the B fragment loads of a warp hit 32 banks.
//
// Decode: a byte_perm gathers byte c of rows (2t, 2t+1) into one word
// (bytes 0 and 2); one lop3 each for the low and the high nibbles (plus a
// shift for the high) forms 0x4300 | (n ^ 8) in both halves, and one bf16x2
// fma subtracts 136 (the magic decode of decode_magic, the XOR folded in).
// A row <-> weight column: CK, tile j (0..3): rows g, g+8 -> columns
// 8g+2j, 8g+2j+1; the low nibbles are k16 block "low half", the high
// nibbles "high half" of the same packed rows, two products into one tile.
// OUT: tile j (0..7): rows g, g+8 -> the low and high nibble of packed
// column 8g+j, i.e. outputs p and N/2 + p; one product.
//
// Reduction, all in the launch and in a fixed order: the warps' sums
// through shared memory in warp order; each block writes its sums into slot
// `rank` of rank 0's receive buffer (distributed shared memory) and
// arrives on the cluster barrier; the other ranks are then done, and rank
// 0 waits, sums the S slots in rank order and applies the epilogue (its
// threads load their scales at the start, so the end of the launch waits
// on no global read). No workspace, no counters: a launch replays bit for
// bit, also from a CUDA graph.
namespace sk {
constexpr int WARPS = 8;
constexpr int NTHREADS = 32 * WARPS;
constexpr int STEP = 16;       // packed rows a warp takes per step
constexpr int COLS = 64;       // packed columns a unit (and a warp) covers
constexpr int MAX_SPLIT = 8;   // blocks of a cluster (portable size)
constexpr int MROWS = 8;       // x rows of the B operand
// shared memory budget of one block; a larger x slice takes the tiled route
constexpr int SMEM_MAX = 160 * 1024;

// outputs of a unit per weight (CK: one per packed column; OUT: two)
template <int MODE>
__host__ __device__ constexpr int unit_outs() { return MODE == CK ? COLS : 2 * COLS; }

// x slice row stride in bf16: >= width, and (stride / 2) % 32 == 4 words,
// so the 32 lanes' B fragment words (row g, word t) fall in 32 banks
__host__ __device__ inline int x_stride(int width) { return (width + 55) / 64 * 64 + 8; }

// shared memory of a block: the x slice, reused after the stream for the
// warps' sums [WARPS][MROWS][EW], then the cluster's receive buffer
// [S][MROWS][EW] (read by rank 0)
template <int MODE, int NW>
inline size_t smem_bytes(int rows_per, int S) {
  const int width = MODE == CK ? 2 * rows_per : rows_per;
  const size_t xs = (size_t)MROWS * x_stride(width) * 2;
  const size_t red = (size_t)WARPS * MROWS * NW * unit_outs<MODE>() * 4;
  const size_t recv = (size_t)S * MROWS * NW * unit_outs<MODE>() * 4;
  return (xs > red ? xs : red) + recv;
}
}  // namespace sk

// 8 bytes at p (VEC: one 8-byte load that skips L1; else byte loads, the
// columns at or past `left` read 0)
template <bool VEC>
__device__ __forceinline__ uint2 sk_load8(const int8_t* __restrict__ p, int left) {
  if (VEC) {
    uint2 v;
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y) : "l"(p));
    return v;
  }
  uint32_t u[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < left) u[j / 4] |= (uint32_t)(uint8_t)__ldg(p + j) << (8 * (j % 4));
  return make_uint2(u[0], u[1]);
}

// bytes c of words a and b at bytes 0 and 2 (bytes 1 and 3 are not read)
__device__ __forceinline__ uint32_t sk_pair(uint2 a, uint2 b, int c) {
  const uint32_t wa = c < 4 ? a.x : a.y, wb = c < 4 ? b.x : b.y;
  const uint32_t s = (uint32_t)(c % 4);
  return __byte_perm(wa, wb, s | (s << 4) | ((4 + s) << 8) | ((4 + s) << 12));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// the two low (hi = false) or high nibbles of a pair word as bf16x2 values
__device__ __forceinline__ uint32_t sk_decode(uint32_t t, bool hi) {
  constexpr uint32_t MASK = 0x000F000Fu, MAGIC_X8 = 0x43084308u;
  constexpr uint32_t ONE = 0x3F803F80u, MINUS136 = 0xC308C308u;
  const uint32_t v = ((hi ? t >> 4 : t) & MASK) ^ MAGIC_X8;   // 0x4300 | (n ^ 8)
  return bf16x2_fma(v, ONE, MINUS136);
}

template <int MODE, int EPI, bool VEC, int PF>
__global__ void __launch_bounds__(sk::NTHREADS, 2)
skinny_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w0,
              const int8_t* __restrict__ w1, const float* __restrict__ s0,
              const float* __restrict__ s1, __nv_bfloat16* __restrict__ out, int M,
              int K, int N, int rows_per, int xvec) {
  using namespace sk;
  namespace cg = cooperative_groups;
  constexpr int NW = EPI == SWIGLU ? 2 : 1;
  constexpr int UO = unit_outs<MODE>();      // outputs a unit, per weight
  constexpr int EW = NW * UO;                // sums a unit, per x row
  constexpr int TILES = MODE == CK ? 4 : 8;  // m16 tiles a warp
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, S = gridDim.x, unit = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int prow = MODE == CK ? K / 2 : K;   // packed rows
  const int pcol = MODE == CK ? N : N / 2;   // packed columns
  const int r0 = rank * rows_per;
  const int nrows = min(prow, r0 + rows_per) - r0;
  const int nsteps = (nrows + STEP - 1) / STEP;
  const int width = MODE == CK ? 2 * rows_per : rows_per;
  const int ldx = x_stride(width);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const size_t xs_bytes = (size_t)MROWS * ldx * 2;
  const size_t red_bytes = (size_t)WARPS * MROWS * EW * 4;
  float* red = reinterpret_cast<float*>(smem);      // reuses the x slice
  float* recv = reinterpret_cast<float*>(smem + (xs_bytes > red_bytes ? xs_bytes : red_bytes));
  // this thread's 8 packed columns: the first and how many are inside
  const int c0 = unit * COLS + 8 * g;
  const int left = pcol - c0;
  // the cluster's barrier, phase 1: every block has started before any
  // writes into rank 0's shared memory (waited for after the stream)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  // rank 0's epilogue scales, loaded now: thread tid finishes the outputs
  // e = tid % UO of the unit (UO divides the block), column n_e
  static_assert(NTHREADS % UO == 0, "a thread keeps one output column");
  const int e_mine = tid % UO;
  int n_mine;
  if (MODE == CK) {
    n_mine = unit * COLS + e_mine;
  } else {
    const int p = unit * COLS + (e_mine % COLS);
    n_mine = p < N / 2 ? (e_mine < COLS ? p : N / 2 + p) : N;
  }
  float sc0 = 0.f, sc1 = 0.f;
  if (rank == 0 && n_mine < N) {
    sc0 = __ldg(s0 + n_mine);
    if (EPI == SWIGLU) sc1 = __ldg(s1 + n_mine);
  }

  // ---- the x slice, first out: CK columns [0, rows_per) are x[:, r0 + j],
  // then x[:, K/2 + r0 + j]; OUT columns are x[:, r0 + j]; zeros past M and
  // past the slice. Whole 16-byte chunks (xvec) copy asynchronously.
  {
    const int chunks = width / 8;
    for (int idx = tid; idx < MROWS * chunks; idx += NTHREADS) {
      const int m = idx / chunks, j0 = (idx % chunks) * 8;
      const int half = MODE == CK && j0 >= rows_per ? 1 : 0;
      const int jj = j0 - half * rows_per;            // offset in the slice
      const __nv_bfloat16* src = x + (size_t)m * K + half * (K / 2) + r0 + jj;
      __nv_bfloat16* dst = xs + (size_t)m * ldx + j0;
      if (m < M && xvec && jj + 8 <= nrows) {
        cp_async16(dst, src);
        continue;
      }
      uint32_t u[4] = {0u, 0u, 0u, 0u};
      if (m < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (jj + e < nrows)
            u[e / 2] |= (uint32_t)__bfloat16_as_ushort(src[e]) << (16 * (e % 2));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // registers of one group of PF steps: rows 2t, 2t+1, 2t+8, 2t+9 of the
  // thread's columns; a step past the slice, a row past it or a thread
  // wholly past the columns loads zeros
  uint2 bufA[PF][NW][4], bufB[PF][NW][4];
  const size_t ld = (size_t)pcol;
  const int8_t* base0 = w0 + (size_t)(r0 + 2 * t) * ld + c0;
  const int8_t* base1 = (NW == 2 ? w1 : w0) + (size_t)(r0 + 2 * t) * ld + c0;
  auto load_group = [&](uint2 (&buf)[PF][NW][4], int first) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int st = first + WARPS * i;
      const int rr = st * STEP + 2 * t;               // row of the slice
      const bool full = st < nsteps && rr + 9 < nrows && left > 0;
      const bool part = st < nsteps && left > 0 && !full;
      const int8_t* b[2] = {base0 + (size_t)st * STEP * ld, base1 + (size_t)st * STEP * ld};
      const int off[4] = {0, 1, 8, 9};
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint2 v = make_uint2(0u, 0u);
          if (full || (part && rr + off[q] < nrows))
            v = sk_load8<VEC>(b[w] + off[q] * ld, left);
          buf[i][w][q] = v;
        }
    }
  };
  // two groups in flight before the wait for x
  const int group = WARPS * PF;                      // steps between two groups of a warp
  int first = warp;
  load_group(bufA, first);
  if (first + group < nsteps) load_group(bufB, first + group);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  float acc[NW][TILES][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int j = 0; j < TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[w][j][e] = 0.f;

  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs) + (size_t)g * (ldx / 2) + t;
  auto compute_group = [&](const uint2 (&buf)[PF][NW][4], int first) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int st = first + WARPS * i;
      if (st >= nsteps) break;
      const int kw = st * STEP / 2;                  // the step's first x word
      const uint32_t blo[2] = {xw[kw], xw[kw + 4]};
      uint32_t bhi[2] = {0u, 0u};
      if (MODE == CK) bhi[0] = xw[kw + rows_per / 2], bhi[1] = xw[kw + rows_per / 2 + 4];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint2* r = buf[i][w];
        if (MODE == CK) {
#pragma unroll
          for (int j = 0; j < TILES; ++j) {
            const uint32_t p0 = sk_pair(r[0], r[1], 2 * j), p1 = sk_pair(r[0], r[1], 2 * j + 1);
            const uint32_t q0 = sk_pair(r[2], r[3], 2 * j), q1 = sk_pair(r[2], r[3], 2 * j + 1);
            const uint32_t alo[4] = {sk_decode(p0, false), sk_decode(p1, false),
                                     sk_decode(q0, false), sk_decode(q1, false)};
            mma_bf16(acc[w][j], alo, blo);
            const uint32_t ahi[4] = {sk_decode(p0, true), sk_decode(p1, true),
                                     sk_decode(q0, true), sk_decode(q1, true)};
            mma_bf16(acc[w][j], ahi, bhi);
          }
        } else {
#pragma unroll
          for (int j = 0; j < TILES; ++j) {
            const uint32_t p = sk_pair(r[0], r[1], j), q = sk_pair(r[2], r[3], j);
            const uint32_t a[4] = {sk_decode(p, false), sk_decode(p, true),
                                   sk_decode(q, false), sk_decode(q, true)};
            mma_bf16(acc[w][j], a, blo);
          }
        }
      }
    }
  };

  // ---- stream: groups of PF steps, double-buffered in registers; a buffer
  // takes the group after next as soon as its own is multiplied
  while (first < nsteps) {
    compute_group(bufA, first);
    first += group;
    if (first >= nsteps) break;
    if (first + group < nsteps) load_group(bufA, first + group);
    compute_group(bufB, first);
    first += group;
    if (first + group < nsteps) load_group(bufB, first + group);
  }
  __syncthreads();                                   // the x slice is spent

  // ---- warps -> block, in warp order. red[warp][m][e]: e is the unit's
  // output (CK: packed column, + UO for the second weight; OUT: packed
  // column, + COLS for its high nibble); C fragment c0/c1 are x rows 2t and
  // 2t+1 of A row g, c2/c3 of A row g+8
  {
    float* rw = red + (size_t)warp * MROWS * EW;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int j = 0; j < TILES; ++j) {
        const int eg = MODE == CK ? w * UO + 8 * g + 2 * j : 8 * g + j;      // A row g
        const int eh = MODE == CK ? eg + 1 : COLS + 8 * g + j;              // A row g+8
        rw[(2 * t) * EW + eg] = acc[w][j][0];
        rw[(2 * t + 1) * EW + eg] = acc[w][j][1];
        rw[(2 * t) * EW + eh] = acc[w][j][2];
        rw[(2 * t + 1) * EW + eh] = acc[w][j][3];
      }
  }
  __syncthreads();
  // the block's sums go to slot `rank` of rank 0's receive buffer (a
  // block alone keeps them in its own)
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");   // phase 1
  {
    float* dst = (S == 1 ? recv : cluster.map_shared_rank(recv, 0)) +
                 (size_t)rank * MROWS * EW;
    for (int i = tid; i < M * EW; i += NTHREADS) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) v += red[(size_t)q * MROWS * EW + i];
      dst[i] = v;                                    // i = m * EW + e
    }
  }
  // phase 2: the sums are in rank 0; the other ranks are done
  if (S == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (rank != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }

  // ---- rank 0: the S slices in rank order, then the epilogue of output
  // column n_mine for x rows m = tid / UO, tid / UO + NTHREADS / UO, ...
  if (n_mine >= N) return;
  for (int m = tid / UO; m < M; m += NTHREADS / UO) {
    float a0 = 0.f, a1 = 0.f;
    for (int q = 0; q < S; ++q) {
      const float* pq = recv + (size_t)q * MROWS * EW + m * EW;
      a0 += pq[e_mine];
      if (NW == 2) a1 += pq[UO + e_mine];
    }
    float v;
    if (EPI == SWIGLU) {
      const float gv = a0 * sc0, u = a1 * sc1;
      v = gv * (1.f / (1.f + expf(-gv))) * u;
    } else {
      v = a0 * sc0;
    }
    out[(size_t)m * N + n_mine] = __float2bfloat16(v);
  }
}

// ------------------------------------------------------------ launchers

// M > 8: f32 x takes the FMA tiles, bf16 x the tensor-core tiles
template <int MODE, int NW, int EPI>
void launch_gemm(const float* x, const int8_t* w0, const int8_t* w1, const float* s0,
                 const float* s1, float* out, int M, int K, int N, cudaStream_t st) {
  const int ncols = MODE == CK ? N : N / 2;
  const int per = MODE == CK ? BN : BN / 2;
  dim3 grid((ncols + per - 1) / per, (M + BM - 1) / BM);
  gemm_kernel<MODE, NW, EPI><<<grid, NT, 0, st>>>(x, w0, w1, s0, s1, out, M, K, N);
}

template <int MODE, int NW, int EPI>
void launch_gemm(const __nv_bfloat16* x, const int8_t* w0, const int8_t* w1,
                 const float* s0, const float* s1, __nv_bfloat16* out, int M, int K,
                 int N, cudaStream_t st) {
  const int ncols = MODE == CK ? N : N / 2;
  const int per = MODE == CK ? 128 / NW : 64 / NW;
  // 16-byte x loads need every 8-slot run to start on a 16-byte boundary
  const bool xvec = (MODE == CK ? (K / 2) % 8 == 0 : K % 8 == 0) &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid((ncols + per - 1) / per, (M + MB - 1) / MB);
  mma_kernel<MODE, NW, EPI><<<grid, NT, 0, st>>>(x, w0, w1, s0, s1, out, M, K, N,
                                                 xvec ? 1 : 0);
}

// ---- tma launcher (host)
// Devices (bit i: device i) on which a kernel's shared memory limit is set,
// one flag a kernel (K names its configuration, I its variant). `static`:
// a flag of each library of its own, also where two builds of this header
// share a process (function-local statics of templates would be unified
// across the libraries by the host compiler).
template <typename K, int I>
static unsigned long long attr_set = 0;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process already holds
// (the kernels' libraries link only the runtime)
inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a 2-D map over rows x cols elements, row stride `ld` elements, with TMA's
// 128- or 64-byte swizzle (0: none); zero fill past the edges
inline bool tensor_map(CUtensorMap* map, const void* base, bool bf16, uint64_t rows,
                       uint64_t cols, uint64_t ld, uint32_t box_cols, uint32_t box_rows,
                       int swizzle) {
  EncodeTiledFn enc = tensor_map_encoder();
  if (!enc) return false;
  const int esize = bf16 ? 2 : 1;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
             : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether TMA can describe the operands of a product with x [M, K] (row
// stride K) and packed weights of this MODE: every row stride a multiple of
// 16 bytes, every base (CK: also x + K/2) 16-byte aligned.
inline bool tma_fits(int MODE, const void* x, const void* w0, const void* w1, int K,
                     int N) {
  if (MODE == CK)
    return K % 16 == 0 && N % 16 == 0 && aligned16(x) && aligned16(w0) &&
           (w1 == nullptr || aligned16(w1));
  return K % 8 == 0 && (N / 2) % 16 == 0 && N % 2 == 0 && aligned16(x) && aligned16(w0);
}

template <int MODE, int EPI, int NWG>
cudaError_t launch_tma_nwg(const CUtensorMap& xl, const CUtensorMap& xh,
                           const CUtensorMap& m0, const CUtensorMap& m1, const float* s0,
                           const float* s1, __nv_bfloat16* out, int M, int K, int N,
                           int dev, int grid, cudaStream_t st) {
  using C = tma::Cfg<NWG>;
  auto kernel = tma_kernel<MODE, EPI, NWG>;
  unsigned long long& ready = attr_set<tma::Cfg<NWG>, MODE * 2 + EPI>;
  if (!(ready >> dev & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    ready |= 1ull << dev;
  }
  kernel<<<grid, C::NTHREADS, C::SMEM_BYTES, st>>>(xl, xh, m0, m1, s0, s1, out, M, K, N);
  return cudaGetLastError();
}

// One persistent block per SM (fewer when the output has fewer tiles).
// Four warpgroups a block read each x tile for twice the weight columns of
// two; they take every shape that still gives three SMs in four a tile (at
// M = 1771: gate/up, down, q/o and both MLP products; k/v keeps two).
template <int MODE, int EPI>
cudaError_t launch_tma(const __nv_bfloat16* x, const int8_t* w0, const int8_t* w1,
                       const float* s0, const float* s1, __nv_bfloat16* out, int M, int K,
                       int N, cudaStream_t st) {
  CUtensorMap xl, xh, m0, m1;
  bool ok;
  if (MODE == CK) {
    ok = tensor_map(&xl, x, true, M, K / 2, K, 64, tma::ROWS, 128) &&
         tensor_map(&xh, x + K / 2, true, M, K / 2, K, 64, tma::ROWS, 128) &&
         tensor_map(&m0, w0, false, K / 2, N, N, 64, 64, 64) &&
         tensor_map(&m1, EPI == SWIGLU ? w1 : w0, false, K / 2, N, N, 64, 64, 64);
  } else {
    ok = tensor_map(&xl, x, true, M, K, K, 64, tma::ROWS, 128) &&
         tensor_map(&m0, w0, false, K, N / 2, N / 2, 64, 128, 64);
    xh = xl;
    m1 = m0;
  }
  if (!ok) return cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return cudaErrorInvalidDevice;
  static int sms[64] = {0};
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int cols = MODE == OUT ? N / 2 : N;
  const int per2 = (MODE == OUT || EPI == SWIGLU) ? 64 : 128;   // columns a tile, NWG = 2
  const int rows = (M + tma::ROWS - 1) / tma::ROWS;
  const int tiles4 = ((cols + 2 * per2 - 1) / (2 * per2)) * rows;
  if (4 * tiles4 >= 3 * sms[dev])
    return launch_tma_nwg<MODE, EPI, 4>(xl, xh, m0, m1, s0, s1, out, M, K, N, dev,
                                        tiles4 < sms[dev] ? tiles4 : sms[dev], st);
  const int tiles2 = ((cols + per2 - 1) / per2) * rows;
  return launch_tma_nwg<MODE, EPI, 2>(xl, xh, m0, m1, s0, s1, out, M, K, N, dev,
                                      tiles2 < sms[dev] ? tiles2 : sms[dev], st);
}

// Routes of one product, as the wrappers count them
enum { ROUTE_GEMV = 0, ROUTE_FMA = 1, ROUTE_MMA = 2, ROUTE_TMA = 3 };

// M > 8: f32 x takes the FMA tiles; bf16 x the TMA/wgmma tiles where TMA can
// describe the operands, else the mma.sync tiles. Returns the route taken.
template <int MODE, int NW, int EPI>
int launch_tiled(const float* x, const int8_t* w0, const int8_t* w1, const float* s0,
                 const float* s1, float* out, int M, int K, int N, cudaStream_t st,
                 cudaError_t* err) {
  launch_gemm<MODE, NW, EPI>(x, w0, w1, s0, s1, out, M, K, N, st);
  *err = cudaSuccess;
  return ROUTE_FMA;
}

template <int MODE, int NW, int EPI>
int launch_tiled(const __nv_bfloat16* x, const int8_t* w0, const int8_t* w1,
                 const float* s0, const float* s1, __nv_bfloat16* out, int M, int K,
                 int N, cudaStream_t st, cudaError_t* err) {
  if (tma_fits(MODE, x, w0, w1, K, N)) {
    *err = launch_tma<MODE, EPI>(x, w0, w1, s0, s1, out, M, K, N, st);
    return ROUTE_TMA;
  }
  launch_gemm<MODE, NW, EPI>(x, w0, w1, s0, s1, out, M, K, N, st);
  *err = cudaSuccess;
  return ROUTE_MMA;
}

// M <= 8, f32 x: the FMA streaming kernel into the workspace, the slices
// summed by launch_finish
template <int MODE, int NW, int MT>
void launch_gemv_mt(const float* x, const int8_t* w0, const int8_t* w1, float* part,
                    int M, int K, int N, int splits, cudaStream_t st) {
  const int prow = MODE == CK ? K / 2 : K;
  const int pcol = MODE == CK ? N : N / 2;
  const int rows_per = (prow + splits - 1) / splits;
  const bool vec = pcol % 4 == 0 && reinterpret_cast<uintptr_t>(w0) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w1) % 4 == 0;
  dim3 grid((pcol + GCOLS - 1) / GCOLS, splits);
  gemv_kernel<MODE, NW, MT><<<grid, NT, 0, st>>>(x, w0, w1, part, M, K, N, rows_per,
                                                 vec ? 1 : 0);
}

template <int MODE, int NW>
void launch_gemv(const float* x, const int8_t* w0, const int8_t* w1, float* part, int M,
                 int K, int N, int splits, cudaStream_t st) {
  if (M <= 1) launch_gemv_mt<MODE, NW, 1>(x, w0, w1, part, M, K, N, splits, st);
  else if (M <= 2) launch_gemv_mt<MODE, NW, 2>(x, w0, w1, part, M, K, N, splits, st);
  else if (M <= 4) launch_gemv_mt<MODE, NW, 4>(x, w0, w1, part, M, K, N, splits, st);
  else launch_gemv_mt<MODE, NW, 8>(x, w0, w1, part, M, K, N, splits, st);
}

// ---- skinny launcher (bf16 x, M <= 8)
template <int MODE, int EPI, bool VEC>
struct Skinny {
  static constexpr int PF = EPI == SWIGLU ? 1 : 2;   // steps a register group
  static auto kernel() { return skinny_kernel<MODE, EPI, VEC, PF>; }

  static cudaLaunchConfig_t config(int S, int units, size_t smem, cudaStream_t st,
                                   cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S, units, 1);
    cfg.blockDim = dim3(sk::NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  // the dynamic shared memory limit, set once per device
  static cudaError_t prepare() {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64) return cudaErrorInvalidDevice;
    unsigned long long& ready = attr_set<Skinny, 0>;
    if (!(ready >> dev & 1ull)) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, sk::SMEM_MAX);
      if (e != cudaSuccess) return e;
      ready |= 1ull << dev;
    }
    return cudaSuccess;
  }

  static cudaError_t launch(const __nv_bfloat16* x, const int8_t* w0, const int8_t* w1,
                            const float* s0, const float* s1, __nv_bfloat16* out, int M,
                            int K, int N, int S, int rows_per, int units, int xvec,
                            size_t smem, cudaStream_t st) {
    cudaError_t e = prepare();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(S, units, smem, st, attr);
    return cudaLaunchKernelEx(&cfg, kernel(), x, w0, w1, s0, s1, out, M, K, N, rows_per,
                              xvec);
  }

  // clusters of S blocks with this shared memory that the device holds at
  // once (cudaOccupancyMaxActiveClusters); 0 on an error
  static int capacity(int S, size_t smem) {
    if (prepare() != cudaSuccess) return 0;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(S, S, smem, 0, attr);
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, kernel(), &cfg) == cudaSuccess ? n : 0;
  }
};

template <int MODE, int EPI>
bool skinny_plan_ok(int K, int N, int S, int rows_per) {
  const int prow = MODE == CK ? K / 2 : K;
  const int pcol = MODE == CK ? N : N / 2;
  return S >= 1 && S <= sk::MAX_SPLIT && rows_per > 0 && rows_per % sk::STEP == 0 &&
         (long long)(S - 1) * rows_per < prow && (long long)S * rows_per >= prow &&
         (pcol + sk::COLS - 1) / sk::COLS <= 65535;
}

// M <= 8, bf16 x: one launch of skinny_kernel on the wrapper's plan (S
// blocks a cluster, rows_per packed rows a block). A plan that does not
// cover the packed rows exactly once is refused (cudaErrorInvalidValue).
// An x slice too large for shared memory takes the tiled route instead.
// Returns the route taken.
template <int MODE, int EPI>
int launch_skinny(const __nv_bfloat16* x, const int8_t* w0, const int8_t* w1,
                  const float* s0, const float* s1, __nv_bfloat16* out, int M, int K,
                  int N, int S, int rows_per, cudaStream_t st, cudaError_t* err) {
  constexpr int NW = EPI == SWIGLU ? 2 : 1;
  const int pcol = MODE == CK ? N : N / 2;
  if (!skinny_plan_ok<MODE, EPI>(K, N, S, rows_per)) {
    *err = cudaErrorInvalidValue;
    return ROUTE_GEMV;
  }
  const size_t smem = sk::smem_bytes<MODE, NW>(rows_per, S);
  if (smem > (size_t)sk::SMEM_MAX)
    return launch_tiled<MODE, NW, EPI>(x, w0, w1, s0, s1, out, M, K, N, st, err);
  const bool vec = pcol % 8 == 0 && reinterpret_cast<uintptr_t>(w0) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(w1 ? w1 : w0) % 8 == 0;
  const int xvec = K % 8 == 0 && (MODE != CK || (K / 2) % 8 == 0) &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int units = (pcol + sk::COLS - 1) / sk::COLS;
  *err = vec ? Skinny<MODE, EPI, true>::launch(x, w0, w1, s0, s1, out, M, K, N, S, rows_per,
                                               units, xvec, smem, st)
             : Skinny<MODE, EPI, false>::launch(x, w0, w1, s0, s1, out, M, K, N, S,
                                                rows_per, units, xvec, smem, st);
  return ROUTE_GEMV;
}

// clusters of S blocks of the streaming kernel for this product (x slices
// of rows_per packed rows) that the device holds at once
template <int MODE, int EPI>
int skinny_capacity(int S, int rows_per) {
  constexpr int NW = EPI == SWIGLU ? 2 : 1;
  if (S < 1 || S > sk::MAX_SPLIT || rows_per <= 0) return 0;
  return Skinny<MODE, EPI, true>::capacity(S, sk::smem_bytes<MODE, NW>(rows_per, S));
}

template <int NW, int EPI>
void launch_finish(const float* part, const float* s0, const float* s1, float* out, int M,
                   int N, int splits, cudaStream_t st) {
  const int total = M * N;
  finish_kernel<NW, EPI><<<(total + NT - 1) / NT, NT, 0, st>>>(part, s0, s1, out, M, N,
                                                               splits);
}

}  // namespace int4k
