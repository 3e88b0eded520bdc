// Matmul with nibble-packed int4 weights for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vlm_fo1_tpu/ops/int4_matmul.py
// (`int4_matmul`, kernel `_kernel`): y [M, N] = (x[:, :K/2] @ lo +
// x[:, K/2:] @ hi) * scale[N], packed [K/2, N] int8 with w[k] in the low
// nibble and w[k + K/2] in the high nibble of byte k, f32 sums, the scale
// applied after the sum, y in x's dtype (f32 or bf16).
//
// What bounds it on the card: at decode (M = 1) the packed bytes, K*N/2 of
// them (11.3 MB for a 2048 -> 11008 projection, 3.4 us at 3.35 TB/s); at
// prefill (M ~ 1771) the 2*M*K*N operations (80 GFLOP, 0.081 ms at the bf16
// tensor-core rate). The TPU kernel unpacked nibbles in VMEM so that HBM
// carried only packed bytes; here too only packed bytes leave device
// memory. M <= 8 with bf16 x streams them once in one launch
// (skinny_kernel): 8-byte register loads double-buffered per warp, the
// magic-number decode into mma.sync A fragments with x as the n = 8
// operand, split K over the blocks of a thread-block cluster and summed in
// rank order through distributed shared memory; f32 x streams with f32
// FMAs and a second launch that sums the slices. M > 8
// with bf16 x runs the TMA-fed wgmma tiles of int4_core.cuh (tma_kernel):
// the nibbles are decoded in registers straight into wgmma's A fragments
// (the product is taken transposed), so no decoded tile touches shared
// memory. Shapes TMA cannot describe (row strides that are not multiples
// of 16 bytes, misaligned pointers) keep the mma.sync tiles, f32 x the FMA
// tiles. Measured at the 3B shapes, the tiled path runs at ~60% of the
// tensor-core rate (PERF.md); the x tile re-read once per column tile
// comes next.

#include "int4_core.cuh"

namespace {

using namespace int4k;

// M <= 8: bf16 x streams in one launch (skinny_kernel, plan S / rows_per);
// f32 x takes the f32 streaming kernel and finish_kernel (workspace ws of
// S * M * N floats, S slices). M > 8: the tiles.
cudaError_t run(const float* x, const int8_t* p, const float* s, float* o, void* ws, int M,
                int K, int N, int S, int, cudaStream_t st, int* route) {
  if (M <= 8) {
    float* part = static_cast<float*>(ws);
    launch_gemv<CK, 1>(x, p, nullptr, part, M, K, N, S, st);
    launch_finish<1, SCALE>(part, s, nullptr, o, M, N, S, st);
    *route = ROUTE_GEMV;
    return cudaGetLastError();
  }
  cudaError_t err;
  *route = launch_tiled<CK, 1, SCALE>(x, p, nullptr, s, nullptr, o, M, K, N, st, &err);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t run(const __nv_bfloat16* x, const int8_t* p, const float* s, __nv_bfloat16* o,
                void*, int M, int K, int N, int S, int rows_per, cudaStream_t st,
                int* route) {
  cudaError_t err;
  *route = M <= 8
               ? launch_skinny<CK, SCALE>(x, p, nullptr, s, nullptr, o, M, K, N, S, rows_per,
                                          st, &err)
               : launch_tiled<CK, 1, SCALE>(x, p, nullptr, s, nullptr, o, M, K, N, st, &err);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x [M, K] (dtype 0 = f32, 1 = bf16), packed [K/2, N] int8, scale [N] f32,
// out [M, N] in x's dtype. M <= 8: bf16 x takes the plan (splits blocks a
// cluster, rows_per packed rows a block; ws unused), f32 x needs ws of
// splits * M * N floats (rows_per unused). Writes the route taken to
// *route (int4k::ROUTE_*) and returns the CUDA error of the launches
// (0 = none).
extern "C" int fo1_int4_matmul(const void* x, const void* packed,
                               const void* scale, void* out, void* ws, int M,
                               int K, int N, int splits, int rows_per,
                               int dtype, void* stream, int* route) {
  *route = -1;
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  cudaError_t err =
      dtype == 0
          ? run(static_cast<const float*>(x), p, s, static_cast<float*>(out), ws, M, K, N,
                splits, rows_per, st, route)
          : run(static_cast<const __nv_bfloat16*>(x), p, s,
                static_cast<__nv_bfloat16*>(out), ws, M, K, N, splits, rows_per, st, route);
  return static_cast<int>(err);
}

// How many clusters of `splits` blocks of the bf16 streaming kernel, each
// staging an x slice of rows_per packed rows, the current device holds at
// once (0 on an error): the wrapper's plan keeps a launch within one wave.
extern "C" int fo1_int4_matmul_capacity(int splits, int rows_per) {
  return int4k::skinny_capacity<int4k::CK, int4k::SCALE>(splits, rows_per);
}
