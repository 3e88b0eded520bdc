// Microbenchmark of small chained matrix products on Hopper (sm_90a).
//
// Replaces the Pallas TPU microbenchmark tools/xp_matmul_floor.py (`run`,
// kernel `kernel`), which measured the floor of the small products the TPU
// MSDA kernel used to select corners. Each of NSTEP steps computes, for a
// block of QB = 1024 queries, out[1024, 128] f32 in row tiles of ROWS rows:
//   chain   sum over 4 slots of lhs[:, 0:128] @ rhs[s*128:(s+1)*128, :]
//   weight  the same, each slot's product times w[:, s*128:(s+1)*128] f32
//   same    rhs block 0 for every slot
//   k512    one lhs[:, 0:512] @ rhs[0:512, :]
// in bf16 with float32 sums, on the tensor cores with
// mma.sync.m16n8k16 (the products are this kernel's own, as they were the
// TPU kernel's; no library call). Every step computes the same tile, as on
// the TPU, and writes it to the same out.
//
// Design: persistent blocks, one per SM, 8 warps; a block stages rhs once
// in shared memory, transposed ([n][k], rows padded by 8 so a warp's B
// fragment loads hit 32 distinct banks), then walks (step, row tile) items;
// each warp computes 16-row tiles of its items, A fragments straight from
// global (L1/L2), the 16 x 128 accumulator in registers. ROWS (64 .. 512)
// sets how many 16-row tiles one item holds: with fewer than 8 a block
// works on several items at once, so all warps are busy at every ROWS.
//
// What bounds it: the tensor-core rate (2 x 1024 x 128 x 512 flops a step,
// 80.5 GFLOP for 600 steps, 0.081 ms at 989 TFLOP/s); the bytes are small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 256;
constexpr int QB = 1024;
constexpr int NSTEP = 600;   // the TPU file's grid
constexpr int N = 128;
enum { CHAIN = 0, WEIGHT = 1, SAME = 2, K512 = 3 };

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows of rhs (K) staged for a variant, and the padded row length
template <int V> struct Shape {
  static constexpr int K = V == SAME ? 128 : 512;
  static constexpr int KP = K + 8;
};

template <int ROWS, int V>
__global__ void __launch_bounds__(BT, 1)
floor_kernel(const __nv_bfloat16* __restrict__ lhs,   // [QB, 512]
             const __nv_bfloat16* __restrict__ rhs,   // [512, 128]
             const float* __restrict__ w,              // [QB, 512]
             float* __restrict__ out) {                 // [QB, 128]
  constexpr int K = Shape<V>::K, KP = Shape<V>::KP;
  constexpr int TILES = ROWS / 16;                     // 16-row tiles an item
  constexpr int IPR = TILES >= 8 ? 1 : 8 / TILES;      // items a round
  extern __shared__ __nv_bfloat16 rt[];                // [N][KP]
  for (int i = threadIdx.x; i < K * N; i += BT) {
    const int k = i / N, n = i % N;
    rt[n * KP + k] = rhs[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long items = (long long)NSTEP * (QB / ROWS);
  const long long rounds = (items + IPR - 1) / IPR;
  for (long long r = blockIdx.x; r < rounds; r += gridDim.x) {
    const long long item = r * IPR + (IPR > 1 ? warp / TILES : 0);
    if (item >= items) continue;
    const int row0 = (int)(item % (QB / ROWS)) * ROWS;
    for (int tile = IPR > 1 ? warp % TILES : warp; tile < TILES;
         tile += IPR > 1 ? TILES : 8) {
      const int r0 = row0 + tile * 16;
      const __nv_bfloat16* a_row0 = lhs + (size_t)(r0 + g) * 512 + 2 * t;
      const __nv_bfloat16* a_row8 = a_row0 + 8 * 512;
      float acc[16][4];
#pragma unroll
      for (int n = 0; n < 16; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      constexpr int SLOTS = V == K512 ? 1 : 4;
      constexpr int KSTEPS = V == K512 ? 32 : 8;
#pragma unroll 1
      for (int s = 0; s < SLOTS; ++s) {
        float part[16][4];
        float (&dst)[16][4] = V == WEIGHT ? part : acc;
        if (V == WEIGHT) {
#pragma unroll
          for (int n = 0; n < 16; ++n)
            part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
        }
        const int kb = V == SAME || V == K512 ? 0 : s * 128;   // rhs rows
#pragma unroll 2
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const int ka = ks * 16;                                // lhs cols
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(a_row0 + ka);
          a[1] = *reinterpret_cast<const uint32_t*>(a_row8 + ka);
          a[2] = *reinterpret_cast<const uint32_t*>(a_row0 + ka + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(a_row8 + ka + 8);
          const __nv_bfloat16* bcol = rt + g * KP + kb + ka + 2 * t;
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            const __nv_bfloat16* bp = bcol + n * 8 * KP;
            mma(dst[n], a, *reinterpret_cast<const uint32_t*>(bp),
                *reinterpret_cast<const uint32_t*>(bp + 8));
          }
        }
        if (V == WEIGHT) {
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            const int c = s * 128 + n * 8 + 2 * t;
            const float2 w0 = *reinterpret_cast<const float2*>(w + (size_t)(r0 + g) * 512 + c);
            const float2 w8 = *reinterpret_cast<const float2*>(w + (size_t)(r0 + g + 8) * 512 + c);
            acc[n][0] += part[n][0] * w0.x;
            acc[n][1] += part[n][1] * w0.y;
            acc[n][2] += part[n][2] * w8.x;
            acc[n][3] += part[n][3] * w8.y;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = n * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)(r0 + g) * N + c) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(out + (size_t)(r0 + g + 8) * N + c) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
}

template <int ROWS, int V>
cudaError_t launch(const void* lhs, const void* rhs, const float* w,
                   float* out, cudaStream_t st) {
  const int smem = N * Shape<V>::KP * 2;
  auto kern = floor_kernel<ROWS, V>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  kern<<<sms, BT, smem, st>>>(static_cast<const __nv_bfloat16*>(lhs),
                              static_cast<const __nv_bfloat16*>(rhs), w, out);
  return cudaGetLastError();
}

}  // namespace

// lhs [1024, 512] bf16, rhs [512, 128] bf16, w [1024, 512] f32 (read by the
// weight variant only), out [1024, 128] f32, written by each of the NSTEP
// steps. variant: 0 chain, 1 weight, 2 same, 3 k512; rows 64, 128, 256 or
// 512. Returns the cudaError_t of the
// launch; the launch does not synchronise.
extern "C" int fo1_matmul_floor_bench(const void* lhs, const void* rhs,
                                      const void* w, void* out, int rows,
                                      int variant, void* stream) {
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLOOR_CASE(R, V)                                                 \
  if (rows == R && variant == V)                                         \
    return (int)launch<R, V>(lhs, rhs, wf, of, st);
  FLOOR_CASE(64, CHAIN)
  FLOOR_CASE(128, CHAIN)
  FLOOR_CASE(256, CHAIN)
  FLOOR_CASE(512, CHAIN)
  FLOOR_CASE(64, WEIGHT)
  FLOOR_CASE(64, SAME)
  FLOOR_CASE(64, K512)
#undef FLOOR_CASE
  return (int)cudaErrorInvalidValue;
}
