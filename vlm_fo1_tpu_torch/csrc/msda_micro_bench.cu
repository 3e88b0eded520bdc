// Microbenchmark of MSDA's gathered sample on Hopper (sm_90a).
//
// Replaces the Pallas TPU microbenchmark tools/xp_msda_micro.py (`run`,
// kernel `kernel`), which timed one MSDA-shaped pass per query-block size
// and index layout. It computes that file's function: for each head h and
// query q (query block j = q / QB, 64-query group g64 = (q % QB) / 64),
//   out[h, q, :] = sum over slots s < 4 of
//       val4[h, max(code[h, j, g64 * 4 + s], 0) + delta[h, q, s], :]
//       * w128[h, q, s * 128 : (s + 1) * 128]
// with w128 = bf16(w4) @ ex, the sum in slot order in float32. The TPU
// kernel selected each row with a one-hot product on its matrix unit; the
// card has a gather, so a sample here is one 256-byte row read (16 bytes a
// lane). ex must be a selection matrix (each column at most one 1, else 0),
// which the wrapper checks and passes as a column map, so w128 is exact.
// A row index is clamped into the band (the TPU file's indices are in it).
//
// Template parameters: QB, the queries of one block (256, 512, 1024), and
// the index layout: query-major delta [H, LQ, 4] and w4 [H, LQ, 16], or
// slot-major ("-t": delta [H, 8, LQ], w4 [H, 16, LQ]). A block stages its
// queries' row indices and rounded weights in shared memory (both layouts
// read coalesced), then each half-warp computes one query's 128 columns.
//
// What bounds it: the output (LQ x 128 float32 a head, written once) and
// the bytes of indices and weights stream from device memory; the gathered
// rows (the 33.5 MB band fits the 50 MB L2) come from L2 and L1. The time
// per sample against the block size and layout is what the MSDA forward
// pays for each of its gathered corners.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 256;
constexpr int S = 4;      // slots
constexpr int D4 = 128;   // columns of a row
constexpr int NW = 16;    // w4 columns

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int QB, bool SLOT_MAJOR>
__global__ void __launch_bounds__(BT)
gather_kernel(const __nv_bfloat16* __restrict__ val4,
              const int* __restrict__ code, const int* __restrict__ delta,
              const float* __restrict__ w4, const signed char* __restrict__ colmap,
              float* __restrict__ out, int rband, int lq, int ncode) {
  extern __shared__ int4 smem_raw[];
  int* rows = reinterpret_cast<int*>(smem_raw);          // [QB][S]
  float* wts = reinterpret_cast<float*>(rows + QB * S);  // [QB][NW]
  const int j = blockIdx.x, h = blockIdx.y;
  const int q0 = j * QB;
  const int* code_row = code + ((size_t)h * ncode + j) * 128;
  // stage the block's row indices and bf16-rounded weights
  for (int idx = threadIdx.x; idx < QB * S; idx += BT) {
    int qi, s, dl;
    if (SLOT_MAJOR) {
      s = idx / QB, qi = idx % QB;
      dl = delta[((size_t)h * 8 + s) * lq + q0 + qi];
    } else {
      qi = idx / S, s = idx % S;
      dl = delta[((size_t)h * lq + q0) * S + idx];
    }
    const int r = max(code_row[(qi / 64) * S + s], 0) + dl;
    rows[qi * S + s] = min(max(r, 0), rband - 1);
  }
  for (int idx = threadIdx.x; idx < QB * NW; idx += BT) {
    int qi, c;
    float v;
    if (SLOT_MAJOR) {
      c = idx / QB, qi = idx % QB;
      v = w4[((size_t)h * NW + c) * lq + q0 + qi];
    } else {
      qi = idx / NW, c = idx % NW;
      v = w4[((size_t)h * lq + q0) * NW + idx];
    }
    wts[qi * NW + c] = bf16_round(v);
  }
  // each lane's 8 columns of each slot: which w4 column weights them
  const int lane16 = threadIdx.x & 15;
  const int c0 = lane16 * 8;
  signed char src[S][8];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int k = 0; k < 8; ++k) src[s][k] = colmap[s * D4 + c0 + k];
  __syncthreads();

  const __nv_bfloat16* band = val4 + (size_t)h * rband * D4 + c0;
  for (int qi = threadIdx.x >> 4; qi < QB; qi += BT / 16) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    const float* wq = wts + qi * NW;
    uint4 raw[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      raw[s] = __ldg(reinterpret_cast<const uint4*>(
          band + (size_t)rows[qi * S + s] * D4));
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t wd[4] = {raw[s].x, raw[s].y, raw[s].z, raw[s].w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t bits = (k & 1) ? (wd[k / 2] & 0xffff0000u) : (wd[k / 2] << 16);
        const float w = src[s][k] >= 0 ? wq[src[s][k]] : 0.f;
        acc[k] += __uint_as_float(bits) * w;
      }
    }
    float4* o = reinterpret_cast<float4*>(out + ((size_t)h * lq + q0 + qi) * D4 + c0);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

template <int QB, bool SLOT_MAJOR>
cudaError_t launch(const void* val4, const int* code, const int* delta,
                   const float* w4, const signed char* colmap, float* out,
                   int heads, int rband, int lq, int ncode, cudaStream_t st) {
  const int smem = QB * (S + NW) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      gather_kernel<QB, SLOT_MAJOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  gather_kernel<QB, SLOT_MAJOR><<<dim3(lq / QB, heads), BT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(val4), code, delta, w4, colmap, out,
      rband, lq, ncode);
  return cudaGetLastError();
}

}  // namespace

// val4 [heads, rband, 128] bf16; code [heads, ncode, 128] int32 (ncode >=
// lq / qb); delta [heads, lq, 4] (query-major) or [heads, 8, lq]
// (slot-major) int32; w4 [heads, lq, 16] or [heads, 16, lq] float32; colmap
// [512] int8: the w4 column that weights each w128 column, -1 for none;
// out [heads, lq, 128] float32. qb in {256, 512, 1024} dividing lq. Returns
// the cudaError_t of the launch; the launch does not synchronise.
extern "C" int fo1_msda_micro_bench(const void* val4, const void* code,
                                    const void* delta, const void* w4,
                                    const void* colmap, void* out, int heads,
                                    int rband, int lq, int ncode, int qb,
                                    int slot_major, void* stream) {
  if (heads <= 0 || rband <= 0 || lq <= 0 || qb <= 0 || lq % qb ||
      ncode < lq / qb)
    return (int)cudaErrorInvalidValue;
  const int* c = static_cast<const int*>(code);
  const int* dl = static_cast<const int*>(delta);
  const float* w = static_cast<const float*>(w4);
  const signed char* cm = static_cast<const signed char*>(colmap);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MICRO_CASE(QB, T)                                                  \
  if (qb == QB && (slot_major != 0) == T)                                  \
    return (int)launch<QB, T>(val4, c, dl, w, cm, o, heads, rband, lq,     \
                              ncode, st);
  MICRO_CASE(256, false)
  MICRO_CASE(256, true)
  MICRO_CASE(512, false)
  MICRO_CASE(512, true)
  MICRO_CASE(1024, false)
  MICRO_CASE(1024, true)
#undef MICRO_CASE
  return (int)cudaErrorInvalidValue;
}
