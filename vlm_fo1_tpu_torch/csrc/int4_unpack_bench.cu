// Microbenchmark of nibble-decode strategies on Hopper (sm_90a): the fused
// int4 MLP's gate/up product.
//
// Replaces the Pallas TPU microbenchmark tools/xp_int4_unpack.py (`build`,
// kernels `kernel` / `nounpack_kernel`) and computes what it computes. With
// x [M, D] bf16 (M <= 8) and gate and up packed [D/2, I] int8 (contraction
// halves: byte [r, n] holds W[r, n] in its low nibble and W[D/2 + r, n] in
// its high one), for each of the I / TI tiles t of TI columns
//   g_t = x[:, :D/2] @ lo(gate_t) + x[:, D/2:] @ hi(gate_t),  u_t likewise
// (bf16 products, f32 sums), and o [M, D] f32 = sum over t of pad(g_t * u_t):
// o[:, :TI] holds the sum, o[:, TI:] zeros. The TPU file's geometry is
// M = 8, D = 2048, I = 11008, TI = 256 (43 tiles). The strategy is the
// decode:
//   0 none    no decode, the TPU file's nounpack_kernel: x[:, :D/2] against
//             the raw bytes, each as a bf16 value in [-128, 127]
//   1 divide  the TPU file's unpack_divide: floor division by 16, the low
//             nibble's sign fixed by a comparison, int -> float -> bf16
//   2 shift   the TPU file's unpack_shift: (p << 28) >> 28 and p >> 4
//   3 float   the TPU file's unpack_float: the byte as a float, floor(p/16)
//             and p - 16 floor(p/16) -- its low value is the UNSIGNED nibble,
//             as in the TPU file
//   4 cvt     the mma_kernel's decode: nib_lo / nib_hi (shift-extend,
//             int -> float), packed to bf16x2
//   5 magic   decode_magic, the tma_kernel's decode (a lop3 and a bf16x2 fma
//             per pair, no int -> float conversion)
//
// What bounds it: the packed bytes, 22.5 MB read once (6.7 us at 3.35 TB/s);
// the products are 0.72 GFLOP (0.7 us on the tensor cores).
//
// Design. The product is taken transposed, out^T = W^T x^T, on
// mma.sync.m16n8k16: decoded weights are the A operand (16 weight columns x
// 16 contraction slots), x^T the n = 8 B operand, so no tensor-core row is
// wasted on M = 8. One block per SM (a cooperative launch, so all are
// resident). An item is 32 packed rows of one tile, all TI = 256 columns,
// of gate and of up: four TMA boxes of 32 rows x 128 bytes with TMA's
// 128-byte swizzle (16 KB). The 43 x 32 items are cut into equal contiguous
// ranges, one per block (10-11 items: every SM streams the same bytes, and a
// range touches at most two tiles). One warp keeps a ring of 4 stages in
// flight (64 KB; 6 and 10 stages were slower); 16 consumer warps decode
// straight from the staged bytes into A fragments, warps w and w + 8 the
// two k16 blocks of the 32 columns 32w .. 32w+31 of every item (at a tile's
// end warp w adds warp w + 8's sums to its own: the block's for those
// columns); x is staged once in shared memory (row stride padded so the B
// fragment loads hit 32 banks; the swizzle makes the A byte loads hit 32
// banks). Wide rows matter: the card keeps only so many row requests in
// flight per SM, and with 32-byte rows the stream ran at well under half
// the rate (PERF.md).
// At the end of each tile of its range a block writes its partial g and u
// of that tile to a workspace. The sum over tiles is nonlinear (g_t * u_t),
// so after a grid-wide barrier every block finishes 16 of the M x TI
// outputs: for each tile it adds the partials of the blocks holding its
// items (3-5 at the TPU file's geometry, at most 8) in block order,
// multiplies g by u, and folds the tiles in a fixed order (32 tile groups in
// shared memory, then in group order). No atomic adds: one launch,
// bit-equal on repeat. The blocks also write o's zero columns.
//
// A second entry mode runs the copy ring alone (the consumers wait for each
// stage and release it unread; o[:, :TI] reads 0): what the stream reaches
// on the card with this kernel's bytes in flight, without the decode.

#include "int4_core.cuh"

namespace {

using namespace int4k;
namespace cg = cooperative_groups;

constexpr int CW = 16;                    // consumer warps
constexpr int NTHREADS = 32 * (CW + 1);   // and the copy warp
constexpr int TW = 256;                   // tile width the kernel takes (TI)
constexpr int ROWS = 32;                  // packed rows of an item
constexpr int BOX = ROWS * 128;           // one TMA box: 32 rows x 128 bytes
constexpr int STAGE = 4 * BOX;            // gate left, right; up left, right
constexpr int STAGES = 4;
constexpr int MROWS = 8;                  // rows of x (the mma's n)
constexpr int MAX_D = 2048;               // x is staged whole
constexpr int XLD = MAX_D + 8;            // x row stride in bf16: (XLD / 2) % 32 == 4
constexpr int MAX_SEG = 2;                // tiles one block's range touches
constexpr int MAX_OWN = 8;                // blocks whose ranges share one tile
constexpr int MAX_T = 64;                 // tiles (I / TI)
constexpr int PART = 2 * MROWS * TW;      // one tile's g and u sums [2][MROWS][TW] f32
constexpr int FOLD_COLS = 16;             // outputs of one row a block finishes
constexpr int GROUPS = CW * 32 / FOLD_COLS;   // tile groups of the fold (32)
static_assert(CW / 2 * 32 == TW && ROWS == 32, "warps w and w + 8: columns 32w .. 32w+31");
// shared memory: the ring (reused by the fold) | x | the k16-block-1 warps'
// sums of each tile of the range | where each tile's partials lie | the
// ring's mbarriers
constexpr int XS_OFF = STAGES * STAGE;
constexpr int PAIR_OFF = XS_OFF + MROWS * XLD * 2;
constexpr int OWN_OFF = PAIR_OFF + MAX_SEG * (CW / 2) * 32 * 16 * 4;
constexpr int BAR_OFF = OWN_OFF + MAX_T * MAX_OWN * 4;
constexpr int SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;   // + alignment slack

enum { NONE = 0, DIVIDE = 1, SHIFT = 2, FLOAT = 3, CVT = 4, MAGIC = 5 };

__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return (int)(int8_t)(uint8_t)(w >> (8 * j));
}

// Two weights of one A fragment register: bytes 0 and 2 of the pair word p
// hold the packed bytes of contraction rows k and k + 1 (bytes 1 and 3 are
// not read). lo gets their low-half values, hi their high-half values, as
// bf16x2 (the first in the low 16 bits); NONE: lo gets the bytes themselves.
template <int STRAT>
__device__ __forceinline__ void decode_pair(uint32_t p, uint32_t& lo, uint32_t& hi) {
  if (STRAT == MAGIC) {
    lo = sk_decode(p, false);
    hi = sk_decode(p, true);
    return;
  }
  float l[2], h[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = sbyte(p, 2 * e);
    if (STRAT == NONE) {
      l[e] = (float)q, h[e] = 0.f;
    } else if (STRAT == DIVIDE) {
      const int hq = q >= 0 ? q / 16 : -((15 - q) / 16);   // floor(q / 16)
      int r = q - 16 * hq;
      r -= 16 * (r >= 8);
      l[e] = (float)r, h[e] = (float)hq;
    } else if (STRAT == SHIFT) {
      l[e] = (float)((int)((uint32_t)q << 28) >> 28), h[e] = (float)(q >> 4);
    } else if (STRAT == FLOAT) {
      const float pf = (float)q;
      const float hf = floorf(pf * (1.0f / 16.0f));
      l[e] = pf - 16.0f * hf, h[e] = hf;
    } else {
      l[e] = nib_lo(p, 2 * e), h[e] = nib_hi(p, 2 * e);
    }
  }
  lo = bf16x2(l[0], l[1]);
  hi = bf16x2(h[0], h[1]);
}

// byte j of a and byte j of b at bytes 0 and 2 of one word
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b, int j) {
  const uint32_t s = (uint32_t)j;
  return __byte_perm(a, b, s | (s << 4) | ((4 + s) << 8) | ((4 + s) << 12));
}

// first item of block q's range (q * items < 2^31: the wrapper's grids)
__device__ __forceinline__ int range_start(int q, int items, int G) {
  return q * items / G;
}

// the block whose range holds item i
__device__ __forceinline__ int owner(int i, int items, int G) {
  int q = i * G / items;
  while (q + 1 < G && range_start(q + 1, items, G) <= i) ++q;
  while (q > 0 && range_start(q, items, G) > i) --q;
  return q;
}

template <int STRAT, bool LOADS_ONLY>
__global__ void __launch_bounds__(NTHREADS, 1)
unpack_kernel(const __grid_constant__ CUtensorMap gmap,
              const __grid_constant__ CUtensorMap umap, const __nv_bfloat16* __restrict__ x,
              float* __restrict__ ws, float* __restrict__ o, int M, int D, int I) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + XS_OFF);
  float* pairs = reinterpret_cast<float*>(smem + PAIR_OFF);
  int* own = reinterpret_cast<int*>(smem + OWN_OFF);   // [T][MAX_OWN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);

  const int G = gridDim.x, blk = blockIdx.x;
  const int T = I / TW, RB = D / 2 / ROWS, items = T * RB;
  const int s0 = range_start(blk, items, G), s1 = range_start(blk + 1, items, G);
  const int tf = s0 / RB;                        // the range's first tile
  const int nseg = s1 > s0 ? (s1 - 1) / RB - tf + 1 : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CW);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // o's zero columns [TW, D), spread over the grid
  {
    const int w = D - TW, nz = M * w;
    for (int i = blk * NTHREADS + tid; i < nz; i += G * NTHREADS)
      o[(size_t)(i / w) * D + TW + i % w] = 0.f;
  }
  __syncthreads();

  if (warp == CW) {
    // ---- copies: one thread keeps the ring full, items in range order
    if (lane == 0) {
      for (int i = s0; i < s1; ++i) {
        const int p = i - s0, s = p % STAGES, use = p / STAGES;
        if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = smem_u32(smem + s * STAGE);
        mbar_expect_tx(full, STAGE);
        const int col = (i / RB) * TW, row = (i % RB) * ROWS;
        tma_load(dst, &gmap, full, col, row);
        tma_load(dst + BOX, &gmap, full, col + 128, row);
        tma_load(dst + 2 * BOX, &umap, full, col, row);
        tma_load(dst + 3 * BOX, &umap, full, col + 128, row);
      }
    }
    __syncwarp();
    // ---- then, while the consumers finish, where each tile's partials will
    // lie, for the fold: the blocks whose ranges hold its items, in block
    // order (their workspace slots; -1 past the last)
    for (int t = lane; t < T; t += 32) {
      int n = 0;
      for (int q = owner(t * RB, items, G); q <= owner((t + 1) * RB - 1, items, G); ++q) {
        const int a = range_start(q, items, G);
        if (range_start(q + 1, items, G) > a) own[t * MAX_OWN + n++] = q * MAX_SEG + t - a / RB;
      }
      for (; n < MAX_OWN; ++n) own[t * MAX_OWN + n] = -1;
    }
  } else {
    // ---- x, whole, in 16-byte chunks; rows past M read zeros
    {
      const int chunks = D / 8;
      for (int i = tid; i < MROWS * chunks; i += CW * 32) {
        const int m = i / chunks, c8 = (i % chunks) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < M) v = *reinterpret_cast<const uint4*>(x + (size_t)m * D + c8);
        *reinterpret_cast<uint4*>(xs + m * XLD + c8) = v;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"r"(CW * 32) : "memory");

    // ---- the stream. Warp w takes k16 block kb = w / 8 of every item and
    // the 32 columns 32 cw .. 32 cw + 31, cw = w % 8 (box cw / 4, columns
    // 32 (cw % 4) .. of the box). Thread (g = lane/4, t4 = lane%4) reads
    // bytes 4g .. 4g+3 of them in packed rows 16kb + 2t4, +1, +8, +9. m16
    // tile j (0, 1): A row g is column 32cw + 4g + 2j, A row g + 8 column
    // 32cw + 4g + 2j + 1. Under the 128-byte swizzle, byte (r, c) of a box
    // sits at r*128 + ((c/16) ^ (r%8))*16 + c%16.
    const int g = lane / 4, t4 = lane % 4, cw = warp % 8, kb = warp / 8;
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs) + g * (XLD / 2) + t4;
    const int cb = 32 * (cw % 4) + 4 * g;                 // column in the box
    const int box = cw / 4;
    for (int sg = 0; sg < nseg; ++sg) {
      const int t = tf + sg;
      const int i0 = max(s0, t * RB), i1 = min(s1, (t + 1) * RB);
      float acc[2][2][4];
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[w][j][e] = 0.f;
      for (int i = i0; i < i1; ++i) {
        const int p = i - s0, s = p % STAGES;
        mbar_wait(full0 + 8 * s, (p / STAGES) & 1);
        if (!LOADS_ONLY) {
          const uint8_t* st = smem + s * STAGE;
          {
            const int k = (i % RB) * ROWS + 16 * kb;             // first packed row
            const uint32_t blo[2] = {xw[k / 2], xw[k / 2 + 4]};
            const uint32_t bhi[2] = {xw[(D / 2 + k) / 2], xw[(D / 2 + k) / 2 + 4]};
            const int r = 16 * kb + 2 * t4;                       // r % 8 == 2 t4 (+1)
            const int off0 = r * 128 + (((cb >> 4) ^ (r & 7)) << 4) + (cb & 15);
            const int off1 = (r + 1) * 128 + (((cb >> 4) ^ ((r + 1) & 7)) << 4) + (cb & 15);
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const uint8_t* bx = st + (2 * w + box) * BOX;
              const uint32_t r0 = *reinterpret_cast<const uint32_t*>(bx + off0);
              const uint32_t r1 = *reinterpret_cast<const uint32_t*>(bx + off1);
              const uint32_t r8 = *reinterpret_cast<const uint32_t*>(bx + off0 + 8 * 128);
              const uint32_t r9 = *reinterpret_cast<const uint32_t*>(bx + off1 + 8 * 128);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                uint32_t alo[4], ahi[4];
                decode_pair<STRAT>(pair(r0, r1, 2 * j), alo[0], ahi[0]);
                decode_pair<STRAT>(pair(r0, r1, 2 * j + 1), alo[1], ahi[1]);
                decode_pair<STRAT>(pair(r8, r9, 2 * j), alo[2], ahi[2]);
                decode_pair<STRAT>(pair(r8, r9, 2 * j + 1), alo[3], ahi[3]);
                mma_bf16(acc[w][j], alo, blo);
                if (STRAT != NONE) mma_bf16(acc[w][j], ahi, bhi);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
      // the block's sums of tile t in its columns: warp cw + 8 hands its
      // sums to warp cw, which adds them to its own and writes them to ws
      // [blk][sg][w][m][c]; C fragment e of tile j: column 32cw + 4g + 2j +
      // e/2, x row 2 t4 + e%2
      float* pr = pairs + (sg * (CW / 2) + cw) * 16 * 32 + lane;   // [16][32 lanes]
      if (kb == 1) {
#pragma unroll
        for (int q = 0; q < 16; ++q) pr[32 * q] = acc[q / 8][(q / 4) % 2][q % 4];
      }
      asm volatile("bar.sync 1, %0;" ::"r"(CW * 32) : "memory");
      if (kb == 0) {
        float* dst = ws + (size_t)(blk * MAX_SEG + sg) * PART;
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dst[(w * MROWS + 2 * t4 + (e & 1)) * TW + 32 * cw + 4 * g + 2 * j + (e >> 1)] =
                  acc[w][j][e] + pr[32 * (8 * w + 4 * j + e)];
      }
    }
  }

  // ---- every block's partials are written
  cg::this_grid().sync();
  // block b finishes the outputs (m, c0 .. c0+15) of chunks b, b + G, ...:
  // thread (c = tid % 16, group = tid / 16) folds the tiles t = group,
  // group + 32, ... in order (each tile's g and u: the partials of the
  // blocks that hold its items, in block order), then 16 threads add the
  // groups in order. The table `own` (written by the copy warp) lists each
  // tile's partials, so a thread's loads are all in flight together.
  float* red = reinterpret_cast<float*>(smem);           // the ring is spent
  const int chunks = M * (TW / FOLD_COLS);
  for (int ch = blk; ch < chunks; ch += G) {
    const int m = ch / (TW / FOLD_COLS), c0 = FOLD_COLS * (ch % (TW / FOLD_COLS));
    if (tid < GROUPS * FOLD_COLS) {
      const int c = c0 + tid % FOLD_COLS, group = tid / FOLD_COLS;
      float f = 0.f;
#pragma unroll 2
      for (int t = group; t < T; t += GROUPS) {
        float gq[MAX_OWN], uq[MAX_OWN];
#pragma unroll
        for (int k = 0; k < MAX_OWN; ++k) {
          const int seg = own[t * MAX_OWN + k];
          const float* pq = ws + (size_t)(seg < 0 ? 0 : seg) * PART;
          gq[k] = seg < 0 ? 0.f : pq[m * TW + c];
          uq[k] = seg < 0 ? 0.f : pq[(MROWS + m) * TW + c];
        }
        float gv = 0.f, uv = 0.f;
#pragma unroll
        for (int k = 0; k < MAX_OWN; ++k) gv += gq[k], uv += uq[k];
        f += gv * uv;
      }
      red[tid] = f;
    }
    __syncthreads();
    if (tid < FOLD_COLS) {
      float v = 0.f;
      for (int group = 0; group < GROUPS; ++group) v += red[group * FOLD_COLS + tid];
      o[(size_t)m * D + c0 + tid] = v;
    }
    __syncthreads();
  }
}

template <int STRAT, bool LOADS_ONLY>
struct Unpack {
  static auto kernel() { return unpack_kernel<STRAT, LOADS_ONLY>; }

  static cudaLaunchConfig_t config(int grid, cudaStream_t st, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid, 1, 1);
    cfg.blockDim = dim3(NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  // the shared memory limit, once per device
  static cudaError_t prepare() {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64) return cudaErrorInvalidDevice;
    unsigned long long& ready = attr_set<Unpack, 0>;
    if (!(ready >> dev & 1ull)) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (e != cudaSuccess) return e;
      ready |= 1ull << dev;
    }
    return cudaSuccess;
  }

  static cudaError_t launch(const CUtensorMap& gm, const CUtensorMap& um,
                            const __nv_bfloat16* x, float* ws, float* o, int M, int D, int I,
                            int grid, cudaStream_t st) {
    cudaError_t e = prepare();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(grid, st, attr);
    e = cudaLaunchKernelEx(&cfg, kernel(), gm, um, x, ws, o, M, D, I);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
};

// whether every block's range of items touches at most MAX_SEG tiles and
// every tile's items lie in at most MAX_OWN blocks' ranges, with `grid`
// blocks
bool plan_fits(int T, int RB, int grid) {
  const int items = T * RB;
  if ((long long)grid * items >= (1ll << 31)) return false;
  int blocks_of_tile = 0, tile = -1;
  for (int q = 0; q < grid; ++q) {
    const int a = q * items / grid, b = (q + 1) * items / grid;
    if (b <= a) continue;
    if ((b - 1) / RB - a / RB + 1 > MAX_SEG) return false;
    for (int t = a / RB; t <= (b - 1) / RB; ++t) {
      blocks_of_tile = t == tile ? blocks_of_tile + 1 : 1;
      tile = t;
      if (blocks_of_tile > MAX_OWN) return false;
    }
  }
  return true;
}

}  // namespace

// x [M, D] bf16 (M <= 8, D a multiple of 64, at most 2048); g, u [D/2, I]
// int8 (I a multiple of 256); tiles of TI = 256 columns; ws: the workspace,
// grid * 2 * 2 * 8 * 256 floats; o [M, D] f32, written whole; pointers
// 16-byte aligned. strategy 0-5 as above; grid: blocks, at most one an SM
// (a cooperative launch), each block's range within two tiles and each
// tile within eight blocks' ranges; loads_only
// != 0 runs the copy ring alone. Returns the CUDA error of the launch (0 =
// none).
extern "C" int fo1_int4_unpack_bench(const void* x, const void* g, const void* u, void* ws,
                                     void* o, int M, int D, int I, int TI, int strategy,
                                     int grid, int loads_only, void* stream) {
  const bool shape_ok = M >= 1 && M <= MROWS && D % (2 * ROWS) == 0 && D >= TW &&
                        D <= MAX_D && TI == TW && I % TW == 0 && I > 0 &&
                        I / TW <= MAX_T && grid >= 1;
  if (!shape_ok || strategy < 0 || strategy > 5 || !aligned16(x) || !aligned16(g) ||
      !aligned16(u) || !aligned16(o) || !plan_fits(I / TW, D / 2 / ROWS, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap gm, um;
  if (!tensor_map(&gm, g, false, D / 2, I, I, 128, ROWS, 128) ||
      !tensor_map(&um, u, false, D / 2, I, I, 128, ROWS, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  float* wp = static_cast<float*>(ws);
  float* op = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (loads_only) {
    err = Unpack<MAGIC, true>::launch(gm, um, xp, wp, op, M, D, I, grid, st);
  } else {
    switch (strategy) {
      case NONE: err = Unpack<NONE, false>::launch(gm, um, xp, wp, op, M, D, I, grid, st); break;
      case DIVIDE: err = Unpack<DIVIDE, false>::launch(gm, um, xp, wp, op, M, D, I, grid, st); break;
      case SHIFT: err = Unpack<SHIFT, false>::launch(gm, um, xp, wp, op, M, D, I, grid, st); break;
      case FLOAT: err = Unpack<FLOAT, false>::launch(gm, um, xp, wp, op, M, D, I, grid, st); break;
      case CVT: err = Unpack<CVT, false>::launch(gm, um, xp, wp, op, M, D, I, grid, st); break;
      default: err = Unpack<MAGIC, false>::launch(gm, um, xp, wp, op, M, D, I, grid, st); break;
    }
  }
  return static_cast<int>(err);
}
