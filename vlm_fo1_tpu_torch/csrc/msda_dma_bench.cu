// Microbenchmark of MSDA's input and output streams on Hopper (sm_90a).
//
// Replaces the Pallas TPU microbenchmark tools/xp_msda_dma.py (`main`,
// `main2`, `main3` -> `build`, kernel `kernel`), which rebuilt the MSDA
// pass structure (8 heads x 299 query blocks of 256 queries, 4 passes) with
// an empty body and added one input block at a time, to price the block
// pipeline alone. Here one templated kernel streams the same arrays with no
// sampling: the floor under any MSDA design. Per head and query block it
// reads (FLAGS):
//   VAL4   the head's value band [26624, 128] bf16, once per head in all
//          (the TPU block was constant over the query blocks)
//   DVM    per-query indices [256, 4] int32
//   W4     per-query weights [256, 16] float32
//   CODE   three code-style arrays, one 128-int row per query block
//          [8, 304, 128] int32 (the TPU file's SMEM blocks)
//   DENSE  three dense arrays [8, 299 * 8, 128] int32, 8 rows a block,
//          through registers
//   DSMEM  the same three staged through shared memory with cp.async (the
//          TPU file's production SMEM layout)
// and writes the out block of zeros [256, OUT_W] float32, as the TPU kernel
// did. Every word read is added into a 32-bit wrapping checksum (so no load
// is dropped, and the plain version can check it); each pass adds its sum
// again. Dynamic shared memory per block (0 to 192 KB, the TPU file's
// `main3` scratch) changes how many blocks share an SM; the first 8 KB of it
// is written and one word read back into the checksum.
//
// What bounds it: the bytes, each array read once and the zeros written
// once a pass, over 3.35 TB/s. Blocks walk query blocks of one head inside
// the block (the TPU grid's sequential axis).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 256;
constexpr int QB = 256;               // queries per block
constexpr int BROWS = QB * 4 / 128;   // dense rows per query block
constexpr int BLOCKS_PER_HEAD = 64;   // each walks ~5 of a head's 299
enum : int { VAL4 = 1, DVM = 2, W4 = 4, CODE = 8, DENSE = 16, DSMEM = 32 };

__device__ __forceinline__ uint32_t fold(uint4 v) { return v.x + v.y + v.z + v.w; }

template <int OUT_W, int FLAGS>
__global__ void __launch_bounds__(BT)
dma_kernel(const uint4* __restrict__ val4, const uint4* __restrict__ dvm,
           const uint4* __restrict__ w4, const uint4* __restrict__ code0,
           const uint4* __restrict__ code1, const uint4* __restrict__ code2,
           const uint4* __restrict__ dense0, const uint4* __restrict__ dense1,
           const uint4* __restrict__ dense2, float4* __restrict__ out,
           unsigned int* __restrict__ checksum, int nqb, int rband,
           int code_rows, int scratch_words) {
  extern __shared__ float scratch[];
  __shared__ uint4 staged[3][BROWS * 128 / 4];
  const int h = blockIdx.y, tid = threadIdx.x;
  const int lq = nqb * QB;
  uint32_t acc = 0;
  if (scratch_words > 0) {
    for (int i = tid; i < min(scratch_words, 2048); i += BT) scratch[i] = 0.f;
    __syncthreads();
    acc += __float_as_uint(scratch[(tid * 7) % min(scratch_words, 2048)]);
  }
  if (FLAGS & VAL4) {
    // the head's band, rows split evenly over the head's blocks
    const long long n16 = (long long)rband * 128 * 2 / 16;
    const long long lo = n16 * blockIdx.x / gridDim.x;
    const long long hi = n16 * (blockIdx.x + 1) / gridDim.x;
    const uint4* band = val4 + (long long)h * n16;
    for (long long i = lo + tid; i < hi; i += BT) acc += fold(__ldg(band + i));
  }
  const uint4* codes[3] = {code0, code1, code2};
  const uint4* denses[3] = {dense0, dense1, dense2};
  const int steps = max(nqb, (FLAGS & CODE) ? code_rows : 0);
  for (int j = blockIdx.x; j < steps; j += gridDim.x) {
    if ((FLAGS & CODE) && j < code_rows && tid < 3 * 32) {
      const uint4* c = codes[tid / 32] + ((long long)h * code_rows + j) * 32;
      acc += fold(__ldg(c + tid % 32));
    }
    if (j >= nqb) continue;
    const long long q0 = (long long)h * lq + (long long)j * QB;
    if (FLAGS & DVM) acc += fold(__ldg(dvm + q0 + tid));   // QB * 4 ints
    if (FLAGS & W4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += fold(__ldg(w4 + q0 * 4 + k * BT + tid));
    }
    // dense rows of this block: BROWS x 128 ints = 256 uint4, one a thread
    const long long d0 = ((long long)h * nqb + j) * BROWS * 32;
    if (FLAGS & DENSE) {
#pragma unroll
      for (int a = 0; a < 3; ++a) acc += fold(__ldg(denses[a] + d0 + tid));
    }
    if (FLAGS & DSMEM) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const uint32_t dst = (uint32_t)__cvta_generic_to_shared(&staged[a][tid]);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(denses[a] + d0 + tid));
      }
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 3; ++a) acc += fold(staged[a][(tid * 5) % BT]);
      __syncthreads();
    }
    // the out block of zeros: QB x OUT_W floats
    float4* o = out + q0 * (OUT_W / 4);
#pragma unroll
    for (int k = 0; k < QB * OUT_W / 4 / BT; ++k)
      o[k * BT + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (tid % 32 == 0) atomicAdd(checksum, acc);
}

template <int OUT_W, int FLAGS>
cudaError_t launch(const void* const* in, void* out, void* checksum,
                   int heads, int nqb, int rband, int code_rows,
                   int scratch_bytes, cudaStream_t st) {
  auto kern = dma_kernel<OUT_W, FLAGS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, scratch_bytes);
  if (e != cudaSuccess) return e;
  auto u = [&](int i) { return static_cast<const uint4*>(in[i]); };
  kern<<<dim3(BLOCKS_PER_HEAD, heads), BT, scratch_bytes, st>>>(
      u(0), u(1), u(2), u(3), u(4), u(5), u(6), u(7), u(8),
      static_cast<float4*>(out), static_cast<unsigned int*>(checksum), nqb,
      rband, code_rows, scratch_bytes / 4);
  return cudaGetLastError();
}

}  // namespace

// in: nine device pointers, null where FLAGS leaves the array out: val4
// [heads, rband, 128] bf16, dvm [heads, nqb*256, 4] int32, w4 [heads,
// nqb*256, 16] f32, code x3 [heads, code_rows, 128] int32, dense x3 [heads,
// nqb*8, 128] int32. out [heads, nqb*256, out_w] f32; checksum one uint32
// the caller zeroed. flags: the OR of VAL4=1, DVM=2, W4=4, CODE=8,
// DENSE=16, DSMEM=32 from the cases below; out_w 32 or 128. One pass; the
// launch does not synchronise.
extern "C" int fo1_msda_dma_bench(const void* const* in, void* out,
                                  void* checksum, int heads, int nqb,
                                  int rband, int code_rows, int flags,
                                  int out_w, int scratch_bytes,
                                  void* stream) {
  if (heads <= 0 || nqb <= 0 || rband <= 0 || code_rows < 0 ||
      scratch_bytes < 0 || scratch_bytes % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DMA_CASE(W, F)                                                    \
  if (out_w == W && flags == (F))                                         \
    return (int)launch<W, (F)>(in, out, checksum, heads, nqb, rband,      \
                               code_rows, scratch_bytes, st);
  DMA_CASE(32, VAL4)
  DMA_CASE(32, VAL4 | DVM)
  DMA_CASE(32, VAL4 | DVM | W4)
  DMA_CASE(32, VAL4 | DVM | W4 | CODE)
  DMA_CASE(32, VAL4 | DVM | W4 | CODE | DENSE)
  DMA_CASE(32, VAL4 | DVM | W4 | CODE | DSMEM)
  DMA_CASE(128, VAL4)
  DMA_CASE(32, 0)
#undef DMA_CASE
  return (int)cudaErrorInvalidValue;
}
