// Shared machinery of the int4 weight kernels (int4_matmul.cu, int4_mlp.cu)
// for Hopper (sm_90a): products of an activation matrix with int4 weights
// stored two nibbles per byte, summed in f32, scaled after the sum.
//
// Two packings of a weight W [Kc, Nc] (contraction x output) into bytes P:
//   CK  (contraction halves)  P [Kc/2, Nc]: P[k, n] = W[k, n] | W[k+Kc/2, n] << 4
//   OUT (output halves)       P [Kc, Nc/2]: P[k, n] = W[k, n] | W[k, n+Nc/2] << 4
// Nibbles are signed (two's complement, [-8, 7]).
//
// Three paths:
//   mma_kernel   (M > 8, bf16 x): tensor-core tiles (mma.sync, bf16 in, f32
//     sums) of 128 rows; x and the unpacked weights staged in shared memory.
//   gemm_kernel  (M > 8, f32 x): a 64 x 64 output tile per block of 256
//     threads, 4 x 4 outputs per thread. Each step stages 32 contraction
//     rows: x as f32 (transposed) and the weight bytes sign-extended once
//     into f32, in shared memory, then 32 FMA rounds from float4 reads.
//     Bound by the f32 FMA rate.
//   gemv_kernel  (M <= 8): streams the packed bytes once, 4 bytes per lane
//     per row (one 32-bit load), 128 packed columns per block; the 8 warps
//     of a block take interleaved rows and the blocks of one column range
//     take consecutive row slices (blockIdx.y). Warps are summed through
//     shared memory and slices through an f32 workspace by finish_kernel,
//     both in a fixed order, so results repeat bit for bit. Bound by the
//     bytes of the packed weight.
// Epilogues: SCALE  out = acc * s0[n]
//            SWIGLU out = silu(acc0 * s0[n]) * (acc1 * s1[n])  (two weights)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// signed nibbles of byte j (0..3) of a little-endian 32-bit word
__device__ __forceinline__ float nib_lo(uint32_t w, int j) {
  return (float)((int32_t)(w << (28 - 8 * j)) >> 28);
}
__device__ __forceinline__ float nib_hi(uint32_t w, int j) {
  return (float)((int32_t)(w << (24 - 8 * j)) >> 28);
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
template <typename T, int MODE, int NW, int EPI>
__global__ void __launch_bounds__(NT)
gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w0,
            const int8_t* __restrict__ w1, const float* __restrict__ s0,
            const float* __restrict__ s1, T* __restrict__ out, int M, int K,
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
        As[j][am] = (m < M && ok) ? to_f(x[(size_t)m * K + k]) : 0.f;
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
      store(out + (size_t)m * N + n, v);
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

// ---------------------------------------------------------------- gemv
// Partial sums of rows [blockIdx.y * rows_per, ...) of the packed weight into
// part[((split * NW + w) * M + m) * N + n], f32, unscaled.
template <typename T, int MODE, int NW, int MT>
__global__ void __launch_bounds__(NT)
gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w0,
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
          const float xl = to_f(x[(size_t)m * K + rr]);
          const float xh = to_f(x[(size_t)m * K + K / 2 + rr]);
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[w][m][j] = fmaf(xh, nib_hi(word[w][u], j),
                                  fmaf(xl, nib_lo(word[w][u], j), acc[w][m][j]));
        } else {
          const float xv = to_f(x[(size_t)m * K + rr]);
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
template <typename T, int NW, int EPI>
__global__ void __launch_bounds__(NT)
finish_kernel(const float* __restrict__ part, const float* __restrict__ s0,
              const float* __restrict__ s1, T* __restrict__ out, int M, int N,
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
  store(out + idx, epilogue<EPI>(a[0], a[NW - 1], s0, s1, n));
}

// ------------------------------------------------------------ launchers

// M > 8: f32 x takes the FMA tiles, bf16 x the tensor-core tiles
template <int MODE, int NW, int EPI>
void launch_gemm(const float* x, const int8_t* w0, const int8_t* w1, const float* s0,
                 const float* s1, float* out, int M, int K, int N, cudaStream_t st) {
  const int ncols = MODE == CK ? N : N / 2;
  const int per = MODE == CK ? BN : BN / 2;
  dim3 grid((ncols + per - 1) / per, (M + BM - 1) / BM);
  gemm_kernel<float, MODE, NW, EPI><<<grid, NT, 0, st>>>(x, w0, w1, s0, s1, out, M, K,
                                                         N);
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

template <typename T, int MODE, int NW, int MT>
void launch_gemv_mt(const T* x, const int8_t* w0, const int8_t* w1, float* part,
                    int M, int K, int N, int splits, cudaStream_t st) {
  const int prow = MODE == CK ? K / 2 : K;
  const int pcol = MODE == CK ? N : N / 2;
  const int rows_per = (prow + splits - 1) / splits;
  const bool vec = pcol % 4 == 0 && reinterpret_cast<uintptr_t>(w0) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w1) % 4 == 0;
  dim3 grid((pcol + GCOLS - 1) / GCOLS, splits);
  gemv_kernel<T, MODE, NW, MT><<<grid, NT, 0, st>>>(x, w0, w1, part, M, K, N,
                                                     rows_per, vec ? 1 : 0);
}

template <typename T, int MODE, int NW>
void launch_gemv(const T* x, const int8_t* w0, const int8_t* w1, float* part,
                 int M, int K, int N, int splits, cudaStream_t st) {
  if (M <= 1) launch_gemv_mt<T, MODE, NW, 1>(x, w0, w1, part, M, K, N, splits, st);
  else if (M <= 2) launch_gemv_mt<T, MODE, NW, 2>(x, w0, w1, part, M, K, N, splits, st);
  else if (M <= 4) launch_gemv_mt<T, MODE, NW, 4>(x, w0, w1, part, M, K, N, splits, st);
  else launch_gemv_mt<T, MODE, NW, 8>(x, w0, w1, part, M, K, N, splits, st);
}

template <typename T, int NW, int EPI>
void launch_finish(const float* part, const float* s0, const float* s1, T* out,
                   int M, int N, int splits, cudaStream_t st) {
  const int total = M * N;
  finish_kernel<T, NW, EPI><<<(total + NT - 1) / NT, NT, 0, st>>>(part, s0, s1, out,
                                                                  M, N, splits);
}

}  // namespace int4k
