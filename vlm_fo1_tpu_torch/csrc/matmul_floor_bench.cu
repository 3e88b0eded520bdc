// Microbenchmark of small chained matrix products on Hopper (sm_90a).
//
// Replaces the Pallas TPU microbenchmark tools/xp_matmul_floor.py (`run`,
// kernel `kernel`), which measured the floor of the small products the TPU
// MSDA kernel used to select corners. Each of nstep steps (the TPU file's
// grid, 600) computes, for a block of QB = 1024 queries, out[1024, 128] f32:
//   chain   sum over 4 slots of lhs[:, 0:128] @ rhs[s*128:(s+1)*128, :]
//   weight  the same, each slot's product times w[:, s*128:(s+1)*128] f32
//   same    rhs block 0 for every slot
//   k512    one lhs[:, 0:512] @ rhs[0:512, :]
// in bf16 with float32 sums. Every step computes the same tile, as on the
// TPU, whose out block stayed in its fast memory across the grid and was
// written back once.
//
// What bounds it: the tensor-core rate (2 x 1024 x 128 x 512 flops a step,
// 80.5 GFLOP for 600 steps, 0.081 ms at 989 TFLOP/s); the bytes are small.
//
// Design: wgmma.mma_async m64n128k16 with f32 accumulators, A from registers
// (RS). Persistent blocks, one per SM, of two warpgroups. A block stages rhs
// once in shared memory with four TMA loads, as it lies in memory (n
// contiguous, 128-byte swizzle): B is read N-major (the instruction's
// transpose flag), so nothing is transposed by hand and the copy overlaps
// the A loads. A warpgroup's job is one step of one 64-row lhs subtile; the
// jobs (16 subtiles x nstep steps, subtile-major) are cut into equal
// contiguous runs, one per warpgroup, so a warpgroup keeps its subtile's A
// fragments in registers across the steps of its run (32 registers; 128 for
// k512) and reloads them only when its run crosses into the next subtile. A
// step is one chain of 32 products into the 64 x 128 accumulator (the first
// with scale-d 0, which starts the step's sum from zero, set through a flag
// the compiler cannot fold: with a constant, a step whose sum the next step
// provably discards may be dropped); weight waits for
// each slot's 8 products and adds them times w (read from L2) into a second
// accumulator. Every step issues all its products; the step count is a
// runtime argument, so the time of nstep 300 against 600 shows that each
// step is computed. A warpgroup writes its subtile's tile when its run
// leaves the subtile (float2 stores, each warp instruction whole 32-byte
// sectors), as the TPU wrote its out block once. The TPU file's row tile
// (64 .. 512 rows a dot) has no counterpart here: wgmma's tile is 64 rows,
// every case runs the same 64-row subtiles, and `rows` is accepted for the
// cases' names only.

#include "int4_core.cuh"   // TMA, mbarrier and descriptor helpers

namespace {

using int4k::mbar_expect_tx;
using int4k::mbar_init;
using int4k::mbar_wait;
using int4k::smem_u32;
using int4k::tma_load;

constexpr int NWG = 2;                 // warpgroups a block
constexpr int NTHREADS = 128 * NWG;
constexpr int QB = 1024;
constexpr int N = 128;
constexpr int K = 512;                 // rhs rows
constexpr int SUB = 64;                // rows of a subtile (wgmma's m)
constexpr int NSUB = QB / SUB;
constexpr int HALF = K * 128;          // rhs columns 64h .. 64h+63, all k rows: bytes
constexpr int SMEM_BYTES = 2 * HALF + 1024 + 16;
enum { CHAIN = 0, WEIGHT = 1, SAME = 2, K512 = 3 };

// 64-bit wgmma shared-memory descriptor of B, N-major with the 128-byte
// swizzle: 64-column atoms HALF bytes apart, 8-row k groups 1024 bytes apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return int4k::gmma_desc(addr, HALF, 1024);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MF_ACC8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
// d = (scale_d ? d : 0) + A (64 x 16 bf16, fragments in registers) * B (16 x
// 128, N-major in shared memory: the transpose flag set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MF_ACC8(0), MF_ACC8(8), MF_ACC8(16), MF_ACC8(24), MF_ACC8(32), MF_ACC8(40),
        MF_ACC8(48), MF_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
#undef MF_ACC8

__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N_>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N_) : "memory");
}

// a warpgroup's 64 x 128 tile, rows r and r + 8 of this thread: C fragment
// 4i + e is column 8i + 2t + e%2 of row r (e < 2) or r + 8
__device__ __forceinline__ void store_tile(float* __restrict__ out, int r, int t,
                                           const float (&v)[64]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * t;
    *reinterpret_cast<float2*>(out + (size_t)r * N + c) = make_float2(v[4 * i], v[4 * i + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(r + 8) * N + c) =
        make_float2(v[4 * i + 2], v[4 * i + 3]);
  }
}

template <int V>
__global__ void __launch_bounds__(NTHREADS, 1)
floor_kernel(const __grid_constant__ CUtensorMap rmap,   // rhs [512, 128] bf16
             const __nv_bfloat16* __restrict__ lhs,      // [QB, 512]
             const float* __restrict__ w,                 // [QB, 512]
             float* __restrict__ out, int nstep) {        // [QB, 128]
  constexpr int KBA = V == K512 ? 32 : 8;   // k16 blocks of A held in registers
  extern __shared__ uint8_t smem_raw[];
  uint8_t* rs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t rb = smem_u32(rs), bar = smem_u32(rs + 2 * HALF);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, 2 * HALF);
    // rhs columns 64h .. 64h+63, k rows 256kh .. 256kh+255
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
        tma_load(rb + h * HALF + kh * (HALF / 2), &rmap, bar, 64 * h, 256 * kh);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long jobs = (long long)NSUB * nstep, gws = (long long)gridDim.x * NWG;
  const long long gw = (long long)blockIdx.x * NWG + wg;
  const long long j1 = (gw + 1) * jobs / gws;
  uint32_t a[KBA][4];
  float d[64], acc[64];   // acc: weight's sum over slots
  bool staged = false;
  // A step's first product starts its sum from zero (scale-d 0). The
  // compiler must not see that: the steps are the same product, and a step
  // whose sum is provably discarded by the next could be dropped or hoisted.
  // `carry` is false for every valid launch but not known when compiling.
  const int carry = nstep < 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = acc[i] = 0.f;

  // runs of one subtile: A fragments in, the steps, the tile out
  for (long long j = gw * jobs / gws; j < j1;) {
    const int sub = (int)(j / nstep);
    const long long jend = min(j1, (long long)(sub + 1) * nstep);
    // A fragments of rows 16 warp + g (+8), k 16kb + 2t (+8), from lhs
    const int r = sub * SUB + 16 * warp + g;
    const __nv_bfloat16* r0 = lhs + (size_t)r * K + 2 * t;
#pragma unroll
    for (int kb = 0; kb < KBA; ++kb) {
      a[kb][0] = __ldg(reinterpret_cast<const uint32_t*>(r0 + 16 * kb));
      a[kb][1] = __ldg(reinterpret_cast<const uint32_t*>(r0 + 8 * K + 16 * kb));
      a[kb][2] = __ldg(reinterpret_cast<const uint32_t*>(r0 + 16 * kb + 8));
      a[kb][3] = __ldg(reinterpret_cast<const uint32_t*>(r0 + 8 * K + 16 * kb + 8));
    }
    if (!staged) {
      mbar_wait(bar, 0);
      staged = true;
    }
    if constexpr (V == WEIGHT) {
      for (; j < jend; ++j) {
        // acc = sum over slots of (lhs_sub @ rhs_s) * w_s
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = carry ? acc[i] : 0.f;
#pragma unroll 1
        for (int sl = 0; sl < 4; ++sl) {
          wg_arrive();
#pragma unroll
          for (int kb = 0; kb < 8; ++kb)
            wgmma_rs(d, a[kb], b_desc(rb + 2048 * (8 * sl + kb)), kb | carry);
          wg_commit();
          wg_wait<0>();
          fence_acc(d);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int c = 128 * sl + 8 * i + 2 * t;
            const float2 w0 = __ldg(reinterpret_cast<const float2*>(w + (size_t)r * K + c));
            const float2 w8 = __ldg(reinterpret_cast<const float2*>(w + (size_t)(r + 8) * K + c));
            acc[4 * i] += d[4 * i] * w0.x;
            acc[4 * i + 1] += d[4 * i + 1] * w0.y;
            acc[4 * i + 2] += d[4 * i + 2] * w8.x;
            acc[4 * i + 3] += d[4 * i + 3] * w8.y;
          }
        }
      }
    } else {
      for (; j < jend; ++j) {
        // one chain of 32 products, the first starting the sum from zero
        wg_arrive();
#pragma unroll
        for (int kk = 0; kk < 32; ++kk) {
          const int kr = V == SAME ? kk % 8 : kk;                  // rhs k16 block
          wgmma_rs(d, a[kk % KBA], b_desc(rb + 2048 * kr), kk | carry);
        }
        wg_commit();
        wg_wait<1>();
      }
      wg_wait<0>();
      fence_acc(d);
    }
    if constexpr (V == WEIGHT) store_tile(out, r, t, acc); else store_tile(out, r, t, d);
  }
  if (!staged) mbar_wait(bar, 0);   // a block with no jobs leaves after its copies land
}

template <int V>
cudaError_t launch(const CUtensorMap& rmap, const void* lhs, const float* w, float* out,
                   int nstep, cudaStream_t st) {
  auto kern = floor_kernel<V>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  kern<<<sms, NTHREADS, SMEM_BYTES, st>>>(rmap, static_cast<const __nv_bfloat16*>(lhs), w,
                                          out, nstep);
  return cudaGetLastError();
}

}  // namespace

// lhs [1024, 512] bf16, rhs [512, 128] bf16, w [1024, 512] f32 (read by the
// weight variant only), out [1024, 128] f32; nstep >= 1 steps (the TPU file's
// 600), every one computed. variant: 0 chain, 1 weight, 2 same, 3 k512;
// rows 64, 128, 256 or 512 (64 for all but chain; the schedule does not
// depend on it, see the header). Returns the cudaError_t of the launch; the
// launch does not synchronise.
extern "C" int fo1_matmul_floor_bench(const void* lhs, const void* rhs, const void* w,
                                      void* out, int rows, int variant, int nstep,
                                      void* stream) {
  const bool rows_ok = rows == 64 || (variant == CHAIN && (rows == 128 || rows == 256 ||
                                                           rows == 512));
  CUtensorMap rmap;
  if (!rows_ok || nstep < 1 || !int4k::aligned16(rhs) ||
      !int4k::tensor_map(&rmap, rhs, true, K, N, N, 64, 256, 128))
    return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case CHAIN: return (int)launch<CHAIN>(rmap, lhs, wf, of, nstep, st);
    case WEIGHT: return (int)launch<WEIGHT>(rmap, lhs, wf, of, nstep, st);
    case SAME: return (int)launch<SAME>(rmap, lhs, wf, of, nstep, st);
    case K512: return (int)launch<K512>(rmap, lhs, wf, of, nstep, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
