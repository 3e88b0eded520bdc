// Microbenchmark of nibble-decode strategies on Hopper (sm_90a).
//
// Replaces the Pallas TPU microbenchmark tools/xp_int4_unpack.py (`build`,
// kernels `kernel` / `nounpack_kernel`): at the fused int4 MLP's geometry
// (gate and up packed [D/2, I] = [1024, 11008] int8, 22.5 MB together) it
// streams the packed bytes once and decodes every nibble to bf16 by one
// strategy. The TPU file fed the decoded tile to its dots; here the decoded
// bf16x2 words are folded into one 32-bit XOR checksum instead (so nothing
// is optimised away and the result is exact), which leaves the decode as
// the only work beside the byte stream. With `lo`/`hi` given, the decoded
// values are written out for the exactness check.
//
// Strategies (the decode functions are the kernels' own, from int4_core.cuh):
//   0 none    the raw words folded as they are: the byte-stream floor
//   1 divide  the TPU file's unpack_divide: floor division by 16, the low
//             nibble's sign fixed by a comparison, int -> float -> bf16
//   2 shift   the TPU file's unpack_shift: (p << 28) >> 28 and p >> 4,
//             int -> float -> bf16
//   3 float   the TPU file's unpack_float: the byte as a float,
//             floor(p / 16) and p - 16 floor(p / 16) -- its low value is the
//             unsigned nibble, as in the TPU file
//   4 cvt     the mma_kernel's decode: nib_lo / nib_hi (shift-extend,
//             int -> float), packed to bf16x2
//   5 magic   decode_magic, the tma_kernel's decode
//
// What bounds it: the packed bytes, 22.5 MB read once (6.7 us at
// 3.35 TB/s); a strategy that costs more than the stream shows above that.

#include "int4_core.cuh"

namespace {

using namespace int4k;

__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return (int)(int8_t)(uint8_t)(w >> (8 * j));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) { return bf16x2(a, b); }

// decoded bf16x2 words of one packed word: lo[0] = (byte 0, byte 1) low
// values, lo[1] = (byte 2, byte 3); hi likewise
template <int STRAT>
__device__ __forceinline__ void decode(uint32_t w, uint32_t (&lo)[2], uint32_t (&hi)[2]) {
  if (STRAT == 5) {
    decode_magic(w, lo, hi);
    return;
  }
  float l[4], h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (STRAT == 1) {
      const int p = sbyte(w, j);
      const int q = p >= 0 ? p / 16 : -((15 - p) / 16);   // floor(p / 16)
      int r = p - 16 * q;
      r -= 16 * (r >= 8);
      l[j] = (float)r, h[j] = (float)q;
    } else if (STRAT == 2) {
      const int p = sbyte(w, j);
      l[j] = (float)((int)((uint32_t)p << 28) >> 28), h[j] = (float)(p >> 4);
    } else if (STRAT == 3) {
      const float pf = (float)sbyte(w, j);
      const float hf = floorf(pf * (1.0f / 16.0f));
      l[j] = pf - 16.0f * hf, h[j] = hf;
    } else {
      l[j] = nib_lo(w, j), h[j] = nib_hi(w, j);
    }
  }
  lo[0] = pack2(l[0], l[1]), lo[1] = pack2(l[2], l[3]);
  hi[0] = pack2(h[0], h[1]), hi[1] = pack2(h[2], h[3]);
}

constexpr int BT = 256;   // threads per block
constexpr int UNROLL = 4; // 16-byte chunks in flight per thread

// src: the two arrays back to back as chunks [0, n16) and [n16, 2 n16)
template <int STRAT, bool WRITE>
__global__ void __launch_bounds__(BT)
unpack_kernel(const uint4* __restrict__ g, const uint4* __restrict__ u, long long n16,
              uint4* __restrict__ lo_out, uint4* __restrict__ hi_out,
              unsigned int* __restrict__ checksum) {
  const long long total = 2 * n16;
  const long long stride = (long long)gridDim.x * BT;
  uint32_t acc = 0;
  for (long long base = (long long)blockIdx.x * BT + threadIdx.x; base < total;
       base += stride * UNROLL) {
    uint4 c[UNROLL];
#pragma unroll
    for (int v = 0; v < UNROLL; ++v) {
      const long long i = base + v * stride;
      c[v] = i < total ? __ldg(i < n16 ? g + i : u + (i - n16)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int v = 0; v < UNROLL; ++v) {
      const long long i = base + v * stride;
      if (i >= total) break;
      const uint32_t w[4] = {c[v].x, c[v].y, c[v].z, c[v].w};
      if (STRAT == 0) {
        acc ^= w[0] ^ w[1] ^ w[2] ^ w[3];
        continue;
      }
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t l2[2], h2[2];
        decode<STRAT>(w[k], l2, h2);
        lo[2 * k] = l2[0], lo[2 * k + 1] = l2[1];
        hi[2 * k] = h2[0], hi[2 * k + 1] = h2[1];
      }
      if (WRITE) {
        // 16 packed bytes -> 16 low and 16 high bf16 values (2 x 16 bytes each)
        lo_out[2 * i] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        lo_out[2 * i + 1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        hi_out[2 * i] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        hi_out[2 * i + 1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc ^= lo[k] ^ hi[k];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if (threadIdx.x % 32 == 0) atomicXor(checksum, acc);
}

template <int STRAT>
cudaError_t launch(const void* g, const void* u, long long n16, void* lo, void* hi,
                   void* checksum, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (2 * n16 + (long long)BT * UNROLL - 1) / ((long long)BT * UNROLL);
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  const uint4* gp = static_cast<const uint4*>(g);
  const uint4* up = static_cast<const uint4*>(u);
  unsigned int* cs = static_cast<unsigned int*>(checksum);
  if (lo != nullptr)
    unpack_kernel<STRAT, true><<<blocks, BT, 0, st>>>(
        gp, up, n16, static_cast<uint4*>(lo), static_cast<uint4*>(hi), cs);
  else
    unpack_kernel<STRAT, false><<<blocks, BT, 0, st>>>(gp, up, n16, nullptr, nullptr, cs);
  return cudaGetLastError();
}

}  // namespace

// g, u: packed bytes, nbytes each (a multiple of 16, 16-byte aligned);
// strategy 0-5 as above; checksum: one uint32 the caller zeroed, XOR-ed
// with every decoded bf16x2 word (strategy 0: every raw word); lo, hi:
// null, or 2 * nbytes bf16 each (g's values, then u's), written with the
// decoded low and high values (not for strategy 0). Returns the CUDA error
// of the launch (0 = none).
extern "C" int fo1_int4_unpack_bench(const void* g, const void* u, long long nbytes,
                                     int strategy, void* lo, void* hi, void* checksum,
                                     void* stream) {
  if (nbytes % 16 != 0 || strategy < 0 || strategy > 5 ||
      (strategy == 0 && lo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n16 = nbytes / 16;
  cudaError_t err;
  switch (strategy) {
    case 0: err = launch<0>(g, u, n16, lo, hi, checksum, st); break;
    case 1: err = launch<1>(g, u, n16, lo, hi, checksum, st); break;
    case 2: err = launch<2>(g, u, n16, lo, hi, checksum, st); break;
    case 3: err = launch<3>(g, u, n16, lo, hi, checksum, st); break;
    case 4: err = launch<4>(g, u, n16, lo, hi, checksum, st); break;
    default: err = launch<5>(g, u, n16, lo, hi, checksum, st); break;
  }
  return static_cast<int>(err);
}
