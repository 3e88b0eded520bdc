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
// memory. M <= 8 streams them once and sign-extends in registers; M > 8
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

template <typename T>
cudaError_t run(const void* x, const void* packed, const void* scale, void* out,
                void* ws, int M, int K, int N, int splits, cudaStream_t st,
                int* route) {
  using namespace int4k;
  const T* xt = static_cast<const T*>(x);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  T* o = static_cast<T*>(out);
  if (M <= 8) {
    float* part = static_cast<float*>(ws);
    launch_gemv<T, CK, 1>(xt, p, nullptr, part, M, K, N, splits, st);
    launch_finish<T, 1, SCALE>(part, s, nullptr, o, M, N, splits, st);
    *route = ROUTE_GEMV;
  } else {
    cudaError_t err;
    *route = launch_tiled<CK, 1, SCALE>(xt, p, nullptr, s, nullptr, o, M, K, N, st, &err);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (dtype 0 = f32, 1 = bf16), packed [K/2, N] int8, scale [N] f32,
// out [M, N] in x's dtype. M <= 8 needs ws of splits * M * N floats.
// Writes the route taken to *route (int4k::ROUTE_*) and returns the CUDA
// error of the launches (0 = none).
extern "C" int fo1_int4_matmul(const void* x, const void* packed,
                               const void* scale, void* out, void* ws, int M,
                               int K, int N, int splits, int dtype,
                               void* stream, int* route) {
  *route = -1;
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? run<float>(x, packed, scale, out, ws, M, K, N, splits, st, route)
          : run<__nv_bfloat16>(x, packed, scale, out, ws, M, K, N, splits, st, route);
  return static_cast<int>(err);
}
