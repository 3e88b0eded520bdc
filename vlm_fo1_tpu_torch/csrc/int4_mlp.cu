// One fused int4 SwiGLU MLP for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vlm_fo1_tpu/ops/int4_mlp.py
// (`int4_mlp_matmul`, kernel `_kernel`):
//   g = (x @ gate) * gs, u = (x @ up) * us   gate/up [D/2, I], contraction halves
//   h = silu(g) * u                           f32, cast to x's dtype
//   y = (h @ down) * ds                       down [I, D/2], output halves:
//                                             byte [i, n] = w[i, n] | w[i, n+D/2] << 4
// with f32 sums and y in x's dtype (f32 or bf16).
//
// What bounds it on the card: at decode (M = 1) the 3*D*I/2 packed bytes
// (33.8 MB at D = 2048, I = 11008: 10 us at 3.35 TB/s); at prefill
// (M ~ 1771) the 6*M*D*I operations (240 GFLOP, 0.24 ms at the bf16
// tensor-core rate).
//
// Design: the TPU kernel walks I in tiles inside one output block and
// carries y across its sequential grid steps. Blocks on the card run in
// parallel and carry nothing, and an atomic sum over I tiles would give
// outputs that change from run to run. So one call is two products, each
// with a fixed summation order:
//   1. gate and up together (both weights' bytes staged per step, one x
//      tile), the SwiGLU epilogue writes h [M, I] in x's dtype -- the cast
//      the TPU kernel makes before its down dot;
//   2. h @ down over the output-half packing: each block owns a range of
//      output columns, its low and high nibbles, and sums all of I itself.
// h is the only intermediate in device memory: 2*M*I bytes in bf16 (22 KB
// at decode), small beside the weights. M <= 8 takes the streaming route of
// int4_core.cuh for both products: with bf16 x one launch each
// (skinny_kernel; the gate and up sums of an h column meet in one rank's
// epilogue after the cluster's in-order reduction), with f32 x two each
// (f32 FMAs, then a launch that sums the slices in order); M > 8 takes the
// tiled paths: for bf16 x the TMA-fed wgmma tiles
// (tma_kernel; the gate and up columns of one h column sit in one thread's
// two accumulator rows, so the SwiGLU epilogue needs no exchange), the
// mma.sync tiles for shapes TMA cannot describe, f32 FMA tiles for f32 x.

#include "int4_core.cuh"

namespace {

using namespace int4k;

// f32 x: M <= 8 streams with f32 FMAs, each product followed by
// finish_kernel (ws of max(2 s1 M I, s2 M D) floats); M > 8 the FMA tiles.
cudaError_t run(const float* x, const int8_t* g, const float* gs, const int8_t* u,
                const float* us, const int8_t* dn, const float* ds, float* h, void* ws,
                float* o, int M, int D, int I, int s1, int, int s2, int, cudaStream_t st,
                int* route) {
  if (M <= 8) {
    float* part = static_cast<float*>(ws);
    launch_gemv<CK, 2>(x, g, u, part, M, D, I, s1, st);
    launch_finish<2, SWIGLU>(part, gs, us, h, M, I, s1, st);
    launch_gemv<OUT, 1>(h, dn, nullptr, part, M, I, D, s2, st);
    launch_finish<1, SCALE>(part, ds, nullptr, o, M, D, s2, st);
    route[0] = route[1] = ROUTE_GEMV;
    return cudaGetLastError();
  }
  cudaError_t err;
  route[0] = launch_tiled<CK, 2, SWIGLU>(x, g, u, gs, us, h, M, D, I, st, &err);
  if (err != cudaSuccess) return err;
  route[1] = launch_tiled<OUT, 1, SCALE>(h, dn, nullptr, ds, nullptr, o, M, I, D, st, &err);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// bf16 x: M <= 8 two launches of skinny_kernel (gate and up with the
// SwiGLU epilogue on plan s1 / r1, down on plan s2 / r2); M > 8 the tiles.
cudaError_t run(const __nv_bfloat16* x, const int8_t* g, const float* gs, const int8_t* u,
                const float* us, const int8_t* dn, const float* ds, __nv_bfloat16* h,
                void*, __nv_bfloat16* o, int M, int D, int I, int s1, int r1, int s2, int r2,
                cudaStream_t st, int* route) {
  cudaError_t err;
  route[0] = M <= 8 ? launch_skinny<CK, SWIGLU>(x, g, u, gs, us, h, M, D, I, s1, r1, st, &err)
                    : launch_tiled<CK, 2, SWIGLU>(x, g, u, gs, us, h, M, D, I, st, &err);
  if (err != cudaSuccess) return err;
  route[1] = M <= 8
                 ? launch_skinny<OUT, SCALE>(h, dn, nullptr, ds, nullptr, o, M, I, D, s2, r2,
                                             st, &err)
                 : launch_tiled<OUT, 1, SCALE>(h, dn, nullptr, ds, nullptr, o, M, I, D, st,
                                               &err);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x [M, D] (dtype 0 = f32, 1 = bf16); gate/up [D/2, I] int8, gs/us [I] f32;
// down [I, D/2] int8, ds [D] f32; h [M, I] and out [M, D] in x's dtype.
// M <= 8: bf16 x takes the plans (s1 blocks a cluster and r1 packed rows a
// block for gate and up, s2 / r2 for down; ws unused), f32 x needs ws of
// max(2*s1*M*I, s2*M*D) floats (r1, r2 unused). Writes the route of each
// product (int4k::ROUTE_*) to route[0] (gate and up) and route[1] (down);
// returns the CUDA error of the launches (0 = none).
extern "C" int fo1_int4_mlp(const void* x, const void* gate, const void* gs,
                            const void* up, const void* us, const void* down,
                            const void* ds, void* h, void* ws, void* out, int M,
                            int D, int I, int s1, int r1, int s2, int r2,
                            int dtype, void* stream, int* route) {
  route[0] = route[1] = -1;
  if (M <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* g = static_cast<const int8_t*>(gate);
  const int8_t* u = static_cast<const int8_t*>(up);
  const int8_t* dn = static_cast<const int8_t*>(down);
  const float* gsf = static_cast<const float*>(gs);
  const float* usf = static_cast<const float*>(us);
  const float* dsf = static_cast<const float*>(ds);
  cudaError_t err =
      dtype == 0
          ? run(static_cast<const float*>(x), g, gsf, u, usf, dn, dsf, static_cast<float*>(h),
                ws, static_cast<float*>(out), M, D, I, s1, r1, s2, r2, st, route)
          : run(static_cast<const __nv_bfloat16*>(x), g, gsf, u, usf, dn, dsf,
                static_cast<__nv_bfloat16*>(h), ws, static_cast<__nv_bfloat16*>(out), M, D,
                I, s1, r1, s2, r2, st, route);
  return static_cast<int>(err);
}

// How many clusters of `splits` blocks of the bf16 streaming kernel the
// current device holds at once, for the gate-and-up product (down = 0) or
// the down product (down = 1), each block staging an x slice of rows_per
// packed rows (0 on an error).
extern "C" int fo1_int4_mlp_capacity(int down, int splits, int rows_per) {
  return down ? int4k::skinny_capacity<int4k::OUT, int4k::SCALE>(splits, rows_per)
              : int4k::skinny_capacity<int4k::CK, int4k::SWIGLU>(splits, rows_per);
}
