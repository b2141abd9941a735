// Kernels H and I: the integer-mask route of ops/blocked.py.
//
// Kernel H (mask_dot_gather) replaces
//   nbody_tpu/ops/pallas/mask_kernels.py : mask_dot_gather (_gather_kernel),
// kernel I (mask_dot_scatter) replaces mask_dot_scatter (_scatter_kernel).
// Kernel J, the fused layer boundary, is csrc/fused_kernels.cu.
//
// H and I, for every (batch, core block) of a lattice cube, with the block's
// masks M (ET, P) stored as int8 or as packed int4 (two signed nibbles per
// byte, the even column in the low nibble):
//   H: out (ET, C) f32 = M . patches (P, C)
//   I: out (P, C)  f32 = M^T . edges (ET, C)
// They are dense products, as the Pallas kernels were: every mask entry is
// multiplied, whatever value it holds (a selection that skipped zeros would
// also change what a NaN or inf in the operand does).  The mask is widened
// exactly to bf16, the operand is bf16, and the products accumulate in f32
// on the tensor cores.
//
// What bounds them on the H100: at the route's shapes (ET 3328, P 1152,
// C <= 64, 512 blocks) one call streams 1.96 GB of int8 mask (0.98 GB
// packed) for 2 * ET * P * C flops per block, 128 flops per int8 mask byte
// at C 64: under the card's ~295 flop/byte ridge, so the floor is the mask
// read (~0.59 ms int8, ~0.29 ms int4), whatever C is.  At C 64 on int4 the
// 251 GFLOP take ~0.25 ms at the 989 TFLOP/s data-sheet rate, and more at
// what mma.sync reaches in practice: there the tensor cores bound I too.
//
// H (mask_gather_kernel, mma.sync.m16n8k16 bf16 -> f32): one CTA per SM
// walks the output tiles (block, R rows of ET, all of C <= 64), a block's
// tiles adjacent so that its patches are served from L2.  R = consumer
// warps x rows per warp, with the accumulators at <= 128 registers a
// thread (gather_cfg; the Python wrapper chooses the tiling and the entry
// checks it): R 1664 at C <= 8, 896 at C 16 and 32, 448 at C 64, so a
// block's patches are read 2, 4 and 8 times (13 before).  The raw mask
// bytes stream through a ring of TMA boxes (csrc/tma_ring.cuh): a producer
// warp issues one 2D box per consumer warp and stage (rows x 64 bytes,
// swizzled by the span, L2 promotion 128 B, evict-normal) into full/empty
// mbarriers, and copies the stage's patch rows beside it with cp.async;
// consumers wait on "full" and arrive on "empty", with no __syncthreads in
// the loop.  Why TMA (scripts/torch_mask_ring.py, the ring alone, H100):
// int8 at C 64's tiling ~2.9 TB/s against ~2.2 for kernel I's cp.async
// ring and ~3.0 for a plain read of the mask; 32-byte stages streamed at
// most ~2.0.  Mask rows whose bytes are not a multiple of 16 take 4-byte
// cp.async or byte loads by the producer into the same layout.  For H the
// mask is A in its stored order, [e][p] = [m][k]: a thread's 32-bit word
// holds 4 int8 (8 int4) values of one row along p, so the k axis is
// permuted inside each 16-byte chunk (gather_k_phys) and the producer
// stores the patch rows in that order, for ldmatrix.trans to read as B.
// The A fragments are widened from the words in registers with kernel I's
// helpers (no F2FP, no bf16 mask tile in shared memory), the swizzle
// keeps the A words free of bank conflicts, and the epilogue stores each
// accumulator pair as a float2 straight from registers.  Rows past a
// block's ET come from the next block or arrive as zeros, and land only on
// rows that are not stored; patch rows past P are zero-filled.  What holds
// it back (variant timings, PERF.md §6): at C 64 the output tile's stores
// (436 MB) at the end of each tile, which the ring overlaps only in part.
//
// I (mask_scatter_kernel, mma.sync.m16n8k16 bf16 -> f32): one CTA owns R
// rows of P by up to 64 columns of C, every row of it for C <= 16, so the
// edge operand of a block is read once (C <= 16, int4 C 32), twice (int4
// C 64) or three times (int8 C 32 and 64) instead of once per 128 rows.
// R = warps x rows per warp, with the accumulators at <= 128 registers a
// thread; scatter_cfg holds the configuration per mask type and width,
// the Python wrapper chooses the tiling and the entry checks it.  The
// reduction axis is walked in stages of edges through a ring in shared
// memory, filled by cp.async straight from the raw mask bytes (16 B, L2
// only, evict-first; a warp copies whole rows) and the bf16 edges (commit
// / wait_group, one barrier per stage); nothing of the mask is staged in
// registers.  A fragments are built from the raw bytes: M^T is [p][e] but
// stored [e][p], so a thread reads 32-bit words along p (4 int8 or 8 int4
// values of one e) and owns a permuted set of output rows: in each
// 32-byte group of a mask row (32 rows of P int8, 64 int4), fragment row
// g (lane / 4) of m16 tile mi holds p = 4g + 2mi (int8) or 8g + 2mi
// (int4), fragment row g + 8 the next p.  The values are widened exactly
// and paired along e into bf16x2 with no conversion instruction: int8
// under the f32 exponent of 2^23 minus 2^23 + 128, whose upper halves are
// the bf16 values, packed by a byte permute; int4 straight into bf16x2
// words 0x43nn (128 + nibble) minus 136.  B fragments come from the edges
// with ldmatrix.trans.  Mask rows are padded by 16 bytes so that the A
// words and the edge rows are read without bank conflicts.  The epilogue
// undoes the row map: every float2 store of a warp fills whole 32-byte
// sectors, so the output goes straight from registers.  Ragged ET, P and C
// are zero-filled in the ring (cp.async with a source size of 0) or masked
// at the store; mask rows whose bytes are not a multiple of 16 take 4-byte
// cp.async, or plain byte loads when not a multiple of 4; edge rows that
// are not 16-byte aligned (C 3) are read into registers before a stage's
// products and stored to the ring after them.
//
// What holds I back (variant timings, PERF.md §6): the ring alone streams
// ~2.2 TB/s (int8) against the ~3.1 TB/s a plain read of the mask reaches,
// and the products and widening (alone ~0.5 ms at C 1, ~1 ms at C 64)
// overlap it only in part, with one barrier per stage and at most 12
// warps on an SM.
//
// Each CTA owns its output tile, with a fixed order of the sums: no
// atomics, and H and I give the same result from launch to launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

typedef __nv_bfloat16 bf16;

const int kColTile = 64;   // output columns per CTA (4 fragments)

// ---------------------------------------------------------------------------
// kernel I
// ---------------------------------------------------------------------------

const int kMaskPad = 16;           // bytes of padding per mask row of a stage
const int kEdgePad = 8;            // bf16 of padding per edge row of a stage

// Kernel I's configuration per mask type and n8 column fragments (nt):
// rows of P a warp owns (nt * rows / 4 f32 accumulators a thread), edges
// per ring stage, ring depth, CTAs per SM the registers are cut for, and
// warps per CTA at most.  Chosen from variant timings on an H100 at the
// route's shapes (PERF.md §6): at C <= 16 a CTA owns all of P in
// six 192-row warps, 32-edge stages 4 deep, registers cut for 2 CTAs per
// SM (the int4 ring fits twice); above, larger stages (fewer barriers per
// edge) and more warps per SM: int8 12 warps of 32 rows at C 64 (three
// row tiles) or 2 CTAs per SM at C 32, int4 10 warps with 128-edge stages
// 2 deep.  Registers are allocated per SM sub-partition: 10 or 12 warps
// (3 a sub-partition) or 2 x 6 leave 168 a thread, and the int4 C > 16
// instances spill a few bytes there, which timed faster than 8 warps.
struct ScatterCfg {
  int rows_per_warp, edges, stages, min_blocks, max_warps;
};

__host__ __device__ constexpr ScatterCfg scatter_cfg(bool int4, int nt) {
  return nt <= 2 ? ScatterCfg{192, 32, 4, 2, 6}
         : int4  ? ScatterCfg{nt >= 8 ? 64 : 128, 128, 2, 1, 10}
         : nt >= 8 ? ScatterCfg{32, 64, 3, 1, 12}
                   : ScatterCfg{64, 64, 3, 2, 8};
}

__host__ __device__ constexpr int scatter_nt(int c) {
  return c > 32 ? 8 : c > 16 ? 4 : c > 8 ? 2 : 1;
}

// dynamic shared memory of the ring: stages x (edges x (mask tile row +
// pad) + edges x (nt * 8 + pad) bf16)
__host__ __device__ inline size_t scatter_smem_bytes(int nt, int rows,
                                                     bool int4) {
  const ScatterCfg cfg = scatter_cfg(int4, nt);
  const int tile_bytes = int4 ? rows / 2 : rows;
  return (size_t)cfg.stages * cfg.edges *
         (tile_bytes + kMaskPad + sizeof(bf16) * (nt * 8 + kEdgePad));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16_evict_first(uint32_t dst,
                                                       const void* src,
                                                       int src_bytes,
                                                       uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(
          dst),
      "l"(src), "r"(src_bytes), "l"(policy));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// int8: byte j of x (the mask byte ^ 0x80) under the f32 exponent of 2^23,
// minus 2^23 + 128: the signed value, exact.  An integer of at most 8
// significant bits leaves the low 16 bits of its f32 zero, so its upper
// half is its bf16, and two of them pack with one byte permute.
__device__ __forceinline__ uint32_t int8_f32(uint32_t x, int j) {
  return __float_as_uint(
      __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | j)) - 8388736.0f);
}

__device__ __forceinline__ uint32_t int8_pair(uint32_t x_lo, uint32_t x_hi,
                                              int j) {
  return __byte_perm(int8_f32(x_lo, j), int8_f32(x_hi, j), 0x7632);
}

// int4: bf16x2 words 0x43nn (128 + nn, nn = nibble ^ 8 < 16) minus 136,
// exact
__device__ __forceinline__ uint32_t int4_pair(uint32_t bytes, int sel) {
  const uint32_t u = __byte_perm(bytes, 0x43434343u, sel);
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(u), "r"(0x43084308u));
  return d;
}

// The A fragments (m16n8k16, row-major 16 x 16 bf16) of the m16 tiles of
// one 32-byte group from its four mask words, at edges 2t, 2t + 1, 2t + 8
// and 2t + 9 of the k16 step.  Fragment row g of tile mi takes value 2mi
// of each word, row g + 8 value 2mi + 1 (value n of a word: byte n for
// int8, nibble n for int4).
template <bool kInt4>
__device__ __forceinline__ void mask_a_frags(const uint32_t (&w)[4],
                                             uint32_t (&a)[kInt4 ? 4 : 2][4]) {
  if constexpr (kInt4) {
    uint32_t lo[4], hi[4];   // bytes: nibbles 0, 2, 4, 6 and 1, 3, 5, 7
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x88888888u;
      lo[i] = x & 0x0F0F0F0Fu;
      hi[i] = (x >> 4) & 0x0F0F0F0Fu;
    }
    // tiles 2q and 2q + 1: byte 2q and 2q + 1 of the words of two edges,
    // interleaved, then each pair under the bf16 exponent of 2^7
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int sel = (2 * q) | ((4 + 2 * q) << 4) | ((2 * q + 1) << 8) |
                      ((5 + 2 * q) << 12);
      const uint32_t u[4] = {__byte_perm(lo[0], lo[1], sel),
                             __byte_perm(hi[0], hi[1], sel),
                             __byte_perm(lo[2], lo[3], sel),
                             __byte_perm(hi[2], hi[3], sel)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[2 * q][r] = int4_pair(u[r], 0x5140);
        a[2 * q + 1][r] = int4_pair(u[r], 0x7362);
      }
    }
  } else {
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = w[i] ^ 0x80808080u;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      a[mi][0] = int8_pair(x[0], x[1], 2 * mi);
      a[mi][1] = int8_pair(x[0], x[1], 2 * mi + 1);
      a[mi][2] = int8_pair(x[2], x[3], 2 * mi);
      a[mi][3] = int8_pair(x[2], x[3], 2 * mi + 1);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mask_access: 16 (16-byte cp.async), 4 (4-byte cp.async) or 1 (byte loads)
template <bool kInt4, int NT>
__global__ void __launch_bounds__(scatter_cfg(kInt4, NT).max_warps * 32,
                                  scatter_cfg(kInt4, NT).min_blocks)
mask_scatter_kernel(const uint8_t* __restrict__ masks,
                    const bf16* __restrict__ x, float* __restrict__ out,
                    int et, int p, int c, int row_tiles, int mask_access,
                    bool vec_x) {
  constexpr int kGrain = kInt4 ? 64 : 32;    // rows of P in 32 mask bytes
  constexpr int kMT = kGrain / 16;           // m16 tiles per group
  constexpr ScatterCfg kCfg = scatter_cfg(kInt4, NT);
  constexpr int kRW = kCfg.rows_per_warp;
  constexpr int kG = kRW / kGrain;           // groups per warp
  constexpr int kE = kCfg.edges;
  constexpr int kS = kCfg.stages;
  constexpr int LDX = NT * 8 + kEdgePad;
  static_assert(kRW % kGrain == 0, "warp rows split into groups");

  extern __shared__ __align__(128) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = nthreads >> 5;
  const int rows = nwarps * kRW;                         // R
  const int tile_bytes = kInt4 ? rows / 2 : rows;
  const int ldm = tile_bytes + kMaskPad;
  const int slot = kE * ldm + kE * LDX * (int)sizeof(bf16);
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(smem);

  const long long blk = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x - blk * row_tiles) * rows;
  const int c0 = blockIdx.y * kColTile;
  const long long rb = kInt4 ? p / 2 : p;                // mask bytes per row
  const long long byte0 = kInt4 ? row0 / 2 : row0;
  const uint8_t* mblk = masks + blk * et * rb;
  const bf16* xblk = x + blk * (long long)et * c;
  const int nst = (et + kE - 1) / kE;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));

  // stage st -> ring slot st % kS: mask rows [e0, e0 + kE) x the tile's
  // bytes, edge rows x columns [c0, c0 + NT * 8); zeros outside the arrays
  auto load_stage = [&](int st) {
    const int e0 = st * kE;
    unsigned char* ms = smem + (st % kS) * slot;
    const uint32_t ms_s = smem_s + (st % kS) * slot;
    const uint32_t xs_s = ms_s + kE * ldm;
    // a warp copies whole mask rows, its lanes along the row
    const int seg = mask_access == 16 ? 16 : 4;
    const int cpr = tile_bytes / seg;
    for (int r = warp; r < kE; r += nwarps) {
      const bool row_ok = e0 + r < et;
      const uint8_t* mrow = mblk + (long long)(e0 + r) * rb + byte0;
      for (int j = lane; j < cpr; j += 32) {
        const bool ok = row_ok && byte0 + j * seg < rb;
        const uint8_t* src = ok ? mrow + j * seg : masks;
        if (mask_access == 16) {
          cp_async16_evict_first(ms_s + r * ldm + j * 16, src, ok ? 16 : 0,
                                 policy);
        } else if (mask_access == 4) {
          cp_async4(ms_s + r * ldm + j * 4, src, ok ? 4 : 0);
        } else {
          uint32_t v = 0u;
          for (int k = 0; ok && k < 4 && byte0 + j * 4 + k < rb; ++k) {
            v |= (uint32_t)src[k] << (8 * k);
          }
          *reinterpret_cast<uint32_t*>(ms + r * ldm + j * 4) = v;
        }
      }
    }
    if (vec_x) {
      for (int i = tid; i < kE * NT; i += nthreads) {
        const int r = i / NT, j = i - r * NT;
        const int cc = c0 + j * 8;
        const bool ok = e0 + r < et && cc < c;
        const bf16* src = ok ? xblk + (long long)(e0 + r) * c + cc : x;
        cp_async16(xs_s + (r * LDX + j * 8) * (int)sizeof(bf16), src, ok ? 16 : 0);
      }
    }
  };

  // edges whose rows are not 16-byte aligned: read into registers before a
  // stage's products and stored to the ring after them, so that the loads'
  // latency hides behind the products (kXBuf values a thread; where a stage
  // holds more, the rest loads at the store)
  constexpr int kXBuf = 4;
  constexpr int kXVals = kE * NT * 8;
  bf16 xbuf[kXBuf];
  auto x_at = [&](int e0, int i) {
    const int r = i / (NT * 8), k = i - r * (NT * 8);
    return e0 + r < et && c0 + k < c ? xblk[(long long)(e0 + r) * c + c0 + k]
                                     : __float2bfloat16_rn(0.0f);
  };
  auto fetch_x = [&](int st) {
#pragma unroll
    for (int q = 0; q < kXBuf; ++q) {
      const int i = tid + q * nthreads;
      if (i < kXVals) xbuf[q] = x_at(st * kE, i);
    }
  };
  auto store_x = [&](int st) {
    bf16* xs = reinterpret_cast<bf16*>(smem + (st % kS) * slot + kE * ldm);
#pragma unroll
    for (int q = 0; q < kXBuf; ++q) {
      const int i = tid + q * nthreads;
      if (i < kXVals) xs[(i / (NT * 8)) * LDX + i % (NT * 8)] = xbuf[q];
    }
    for (int i = tid + kXBuf * nthreads; i < kXVals; i += nthreads) {
      xs[(i / (NT * 8)) * LDX + i % (NT * 8)] = x_at(st * kE, i);
    }
  };

  float acc[kG][kMT][NT][4];
#pragma unroll
  for (int gi = 0; gi < kG; ++gi)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[gi][mi][nj][q] = 0.0f;

  const int g = lane >> 2, t = lane & 3;
  // a warp whose rows all lie past P copies but does not multiply
  const bool active = row0 + warp * kRW < p;
  // ldmatrix(.x4).trans row addresses: lane l gives row l % 8 of matrix
  // l / 8 (matrices: k 0-7 / 8-15 of n-tile 2u, then of n-tile 2u + 1)
  const int ld_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int ld_n = (lane >> 4) * 8;

#pragma unroll 1
  for (int st = 0; st < kS - 1; ++st) {
    if (st < nst) {
      load_stage(st);
      if (!vec_x) {
        fetch_x(st);
        store_x(st);
      }
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    const int next = st + kS - 1;   // the stage loaded now, into st - 1's slot
    cp_async_wait<kS - 2>();
    __syncthreads();   // stage st landed; every warp is done with st - 1
    if (next < nst) {
      load_stage(next);
      if (!vec_x) fetch_x(next);
    }
    cp_async_commit();
    if (!active) {
      if (!vec_x && next < nst) store_x(next);
      continue;
    }
    const unsigned char* ms = smem + (st % kS) * slot;
    const uint32_t xs_s = smem_s + (st % kS) * slot + kE * ldm;
#pragma unroll
    for (int kk = 0; kk < kE / 16; ++kk) {
      uint32_t b[NT][2];
      const uint32_t brow = xs_s + ((kk * 16 + ld_k) * LDX) * (int)sizeof(bf16);
      if constexpr (NT == 1) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
            : "=r"(b[0][0]), "=r"(b[0][1])
            : "r"(brow));
      } else {
#pragma unroll
        for (int u = 0; u < NT / 2; ++u) {
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0, %1, %2, %3}, [%4];\n"
              : "=r"(b[2 * u][0]), "=r"(b[2 * u][1]), "=r"(b[2 * u + 1][0]),
                "=r"(b[2 * u + 1][1])
              : "r"(brow + (u * 16 + ld_n) * (int)sizeof(bf16)));
        }
      }
      const unsigned char* mrow = ms + (kk * 16 + 2 * t) * ldm + 4 * g;
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        const unsigned char* mp = mrow + (warp * kG + gi) * 32;
        const uint32_t w[4] = {*reinterpret_cast<const uint32_t*>(mp),
                               *reinterpret_cast<const uint32_t*>(mp + ldm),
                               *reinterpret_cast<const uint32_t*>(mp + 8 * ldm),
                               *reinterpret_cast<const uint32_t*>(mp + 9 * ldm)};
        uint32_t a[kMT][4];
        mask_a_frags<kInt4>(w, a);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int nj = 0; nj < NT; ++nj)
            mma_bf16(acc[gi][mi][nj], a[mi], b[nj][0], b[nj][1]);
      }
    }
    if (!vec_x && next < nst) store_x(next);
  }
  cp_async_wait<0>();
  if (!active) return;

  // out row of fragment row g (+ 8 for h = 1) of tile mi in group gi:
  // p = row0 + warp * kRW + gi * kGrain + (kGrain / 8) * g + 2 * mi + h
  float* oblk = out + blk * p * (long long)c;
  const bool pairs = c % 2 == 0;
#pragma unroll
  for (int gi = 0; gi < kG; ++gi)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pr = row0 + warp * kRW + gi * kGrain + (kGrain / 8) * g +
                       2 * mi + h;
        if (pr >= p) continue;
        float* orow = oblk + (long long)pr * c;
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          const int cc = c0 + nj * 8 + 2 * t;
          const float v0 = acc[gi][mi][nj][2 * h], v1 = acc[gi][mi][nj][2 * h + 1];
          if (pairs && cc + 1 < c) {
            *reinterpret_cast<float2*>(orow + cc) = make_float2(v0, v1);
          } else {
            if (cc < c) orow[cc] = v0;
            if (cc + 1 < c) orow[cc + 1] = v1;
          }
        }
      }
}

template <bool kInt4, int NT>
cudaError_t launch_scatter(const uint8_t* masks, const bf16* x, float* out,
                           long long bnb, int et, int p, int c, int warps,
                           int row_tiles, int smem, cudaStream_t stream) {
  auto kernel = mask_scatter_kernel<kInt4, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long rb = kInt4 ? p / 2 : p;
  const uintptr_t mp = (uintptr_t)masks;
  const int access = rb % 16 == 0 && mp % 16 == 0 ? 16
                     : rb % 4 == 0 && mp % 4 == 0 ? 4 : 1;
  const bool vec_x = c % 8 == 0 && (uintptr_t)x % 16 == 0;
  const dim3 grid((unsigned)(bnb * row_tiles),
                  (unsigned)((c + kColTile - 1) / kColTile));
  kernel<<<grid, warps * 32, smem, stream>>>(masks, x, out, et, p, c,
                                              row_tiles, access, vec_x);
  return cudaGetLastError();
}

template <bool kInt4>
cudaError_t scatter_nt(const uint8_t* masks, const bf16* x, float* out,
                       long long bnb, int et, int p, int c, int nt, int warps,
                       int row_tiles, int smem, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_scatter<kInt4, 1>(masks, x, out, bnb, et, p, c, warps, row_tiles, smem, stream);
    case 2: return launch_scatter<kInt4, 2>(masks, x, out, bnb, et, p, c, warps, row_tiles, smem, stream);
    case 4: return launch_scatter<kInt4, 4>(masks, x, out, bnb, et, p, c, warps, row_tiles, smem, stream);
    default: return launch_scatter<kInt4, 8>(masks, x, out, bnb, et, p, c, warps, row_tiles, smem, stream);
  }
}

// ---------------------------------------------------------------------------
// kernel H
// ---------------------------------------------------------------------------

// Kernel H's configuration per n8 column fragments (nt): rows of ET a
// consumer warp owns ((rows / 16) * nt * 4 f32 accumulators a thread,
// <= 128), ring stages, and consumer warps per CTA at most.  Each stage
// holds kGatherSpan mask bytes of every row of the tile.  Chosen from
// variant timings on an H100 at the route's shapes (PERF.md §6): 13 warps
// and 2 stages at C <= 8 (R 1664: a block's patches read twice), 8 warps
// and 3 stages at C 16 and 7 at C 32 (R 896: four times), 7 warps of 64
// rows and 4 stages at C 64 (R 448: eight times), where 8 warps spilled.
// Registers are allocated per SM sub-partition: 13 to 16 warps (the
// consumers and the producer) leave 128 a thread, 9 to 12 leave 168, 8 or
// fewer 255.  The ring holds 150-227 KB, one CTA per SM.
struct GatherCfg {
  int rows_per_warp, stages, max_warps;
};

__host__ __device__ constexpr GatherCfg gather_cfg(int nt) {
  return nt == 1   ? GatherCfg{128, 2, 13}
         : nt == 2 ? GatherCfg{128, 3, 8}
         : nt == 4 ? GatherCfg{128, 3, 7}
                   : GatherCfg{64, 4, 7};
}

// mask bytes of a row per ring stage: the TMA box's inner extent and its
// swizzle span (32-byte stages streamed at most ~2.0 TB/s, PERF.md)
const int kGatherSpan = 64;

// bf16 per row of a stage's patch tile: nt * 8 columns (at least 16), and
// a pad that lets ldmatrix read 8 consecutive rows without bank conflicts
__host__ __device__ constexpr int gather_ldx(int nt) {
  return (nt < 2 ? 2 : nt) * 8 + 8;
}

const int kSmemAlign = 1024;   // the largest TMA swizzle atom

// dynamic shared memory: the alignment slack, then per stage the mask tile
// (rows x stage bytes), the patch tile (its rows x gather_ldx bf16) and
// the stage's two mbarriers
__host__ __device__ inline size_t gather_smem_bytes(int nt, int rows,
                                                    bool int4) {
  const int kp = int4 ? 2 * kGatherSpan : kGatherSpan;
  return kSmemAlign +
         (size_t)gather_cfg(nt).stages *
             ((size_t)rows * kGatherSpan +
              (size_t)kp * gather_ldx(nt) * sizeof(bf16) + 2 * sizeof(uint64_t));
}

// Kernel H's k permutation: row l of a stage's patch tile (the mma's k)
// holds patch row gather_k_phys(l) of the stage.  In each 16-row group
// (int8) the mma's k slots 2t, 2t + 1, 2t + 8, 2t + 9 of lane t take p =
// 4t .. 4t + 3, the bytes of the lane's mask word; in each 32-row group
// (int4) k16 step s takes nibbles 4s, 4s + 2 (slots 2t, 2t + 1) and 4s +
// 1, 4s + 3 (2t + 8, 2t + 9) of the word that holds p = 8t .. 8t + 7.
template <bool kInt4>
__device__ __forceinline__ int gather_k_phys(int l) {
  const int q = l & 15;
  if constexpr (kInt4) {
    return (l & ~31) | (((q & 7) >> 1) << 3) | (((l >> 4) & 1) << 2) |
           ((q & 1) << 1) | (q >> 3);
  } else {
    return (l & ~15) | (((q & 7) >> 1) << 2) | ((q >> 3) << 1) | (q & 1);
  }
}

// The A fragments (m16n8k16, row-major) of one m16 tile for k16 step ks
// of a 16-byte chunk of the stage, from the tile's words of rows g (w0)
// and g + 8 (w1): the chunk is one k16 step (int8) or two (int4), along
// gather_k_phys.  int8 widens each byte under the f32 exponent of 2^23 and
// packs the upper halves; int4 builds bf16x2 words 0x43nn straight from
// the nibbles (kernel I's helpers).
template <bool kInt4>
__device__ __forceinline__ void gather_a_frag(uint32_t w0, uint32_t w1, int ks,
                                              uint32_t (&a)[4]) {
  if constexpr (kInt4) {
    const uint32_t x0 = w0 ^ 0x88888888u, x1 = w1 ^ 0x88888888u;
    const int sel = ks ? 0x7362 : 0x5140;   // bytes 2ks, 2ks + 1
    a[0] = int4_pair(x0 & 0x0F0F0F0Fu, sel);
    a[1] = int4_pair(x1 & 0x0F0F0F0Fu, sel);
    a[2] = int4_pair((x0 >> 4) & 0x0F0F0F0Fu, sel);
    a[3] = int4_pair((x1 >> 4) & 0x0F0F0F0Fu, sel);
  } else {
    const uint32_t x0 = w0 ^ 0x80808080u, x1 = w1 ^ 0x80808080u;
    a[0] = __byte_perm(int8_f32(x0, 0), int8_f32(x0, 1), 0x7632);
    a[1] = __byte_perm(int8_f32(x1, 0), int8_f32(x1, 1), 0x7632);
    a[2] = __byte_perm(int8_f32(x0, 2), int8_f32(x0, 3), 0x7632);
    a[3] = __byte_perm(int8_f32(x1, 2), int8_f32(x1, 3), 0x7632);
  }
}

// One CTA per SM walks the tiles (block, R-row tile, 64-column tile) in
// order, a block's tiles adjacent; warps 0 .. warps - 1 consume, the last
// warp produces.  mask_access: 16 (TMA boxes of the tensor map), 4
// (4-byte cp.async) or 1 (byte loads), both into the swizzled layout.
template <bool kInt4, int NT>
__global__ void __launch_bounds__((gather_cfg(NT).max_warps + 1) * 32, 1)
mask_gather_kernel(const __grid_constant__ CUtensorMap mask_map,
                   const uint8_t* __restrict__ masks,
                   const bf16* __restrict__ x, float* __restrict__ out, int et,
                   int p, int c, int row_tiles, int col_tiles, long long ntiles,
                   int mask_access, bool vec_x) {
  using namespace tma_ring;
  constexpr GatherCfg kCfg = gather_cfg(NT);
  constexpr int kRW = kCfg.rows_per_warp;
  constexpr int kW = kGatherSpan;
  constexpr int kS = kCfg.stages;
  constexpr int kMT = kRW / 16;                // m16 tiles a warp
  constexpr int kKS = kInt4 ? 2 : 1;           // k16 steps a 16-byte chunk
  constexpr int kKP = kInt4 ? 2 * kW : kW;     // patch rows a stage
  constexpr int LDX = gather_ldx(NT);
  static_assert(kRW % 16 == 0 && kRW <= 256, "a warp's rows are one TMA box");

  extern __shared__ unsigned char smem_raw[];
  const int warps = blockDim.x / 32 - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = warps * kRW;
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw_s + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1);
  unsigned char* const smem = smem_raw + (base - raw_s);
  const int mstage = rows * kW;
  const int xstage = kKP * LDX * (int)sizeof(bf16);
  const int xs0 = kS * mstage;                 // byte offsets from base
  const uint32_t bar0 = base + xs0 + kS * xstage;
  const long long rb = kInt4 ? p / 2 : p;      // mask bytes per row
  const int nst = (int)((rb + kW - 1) / kW);

  // full[s]: each producer lane's cp.async arrival and plain arrival, and
  // lane 0's arrival for the mask tile; empty[s]: one per consumer warp
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar0 + 8 * s, 65);
      mbar_init(bar0 + 8 * (kS + s), warps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  int it = 0;   // stages walked, over tiles
  if (warp == warps) {
    uint64_t policy;
    // evict-normal: the second half of each 128-byte line the TMA promotes
    // into L2 must stay there for the next stage (evict-first lost it to
    // the output stores: int8 C 16 1.23 against 0.81 ms, PERF.md)
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(policy));
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long rest = tile / col_tiles;
      const int c0 = (int)(tile - rest * col_tiles) * kColTile;
      const long long blk = rest / row_tiles;
      const int row0 = (int)(rest - blk * row_tiles) * rows;
      const int live = min(warps, (et - row0 + kRW - 1) / kRW);
      const uint8_t* mblk = masks + blk * et * rb;
      const bf16* xblk = x + blk * (long long)p * c;
      for (int st = 0; st < nst; ++st, ++it) {
        const int s = it % kS;
        const uint32_t full = bar0 + 8 * s;
        mbar_wait(bar0 + 8 * (kS + s), (uint32_t)((it / kS) & 1) ^ 1u);
        const int ms = s * mstage;
        if (mask_access == 16) {
          // one box per warp of live rows; rows past the block's ET come
          // from the next block (their outputs are not stored), bytes past
          // the row and rows past the array arrive as zeros
          if (lane == 0) {
            mbar_arrive_expect_tx(full, (uint32_t)(live * kRW * kW));
            for (int w = 0; w < live; ++w) {
              tma_load_2d(base + ms + w * kRW * kW, &mask_map, st * kW,
                          (int)(blk * et) + row0 + w * kRW, full, policy);
            }
          }
        } else {
          constexpr int kCpr = kW / 4;
          for (int i = lane; i < rows * kCpr; i += 32) {
            const int r = i / kCpr, j = i - r * kCpr;
            const long long byte = (long long)st * kW + 4 * j;
            const bool ok = row0 + r < et && byte < rb;
            const uint8_t* src = ok ? mblk + (long long)(row0 + r) * rb + byte : masks;
            const int dst = ms + swizzle<kW>(r * kW + 4 * j);
            if (mask_access == 4) {
              cp_async4(base + dst, src, ok ? 4 : 0);
            } else {
              uint32_t v = 0u;
              for (int k = 0; ok && k < 4 && byte + k < rb; ++k) {
                v |= (uint32_t)src[k] << (8 * k);
              }
              *reinterpret_cast<uint32_t*>(smem + dst) = v;
            }
          }
          if (lane == 0) mbar_arrive(full);
        }
        // the stage's patch rows in k order, columns [c0, c0 + NT * 8);
        // zeros past P and C (a zero mask entry times a NaN is NaN)
        const int xs = xs0 + s * xstage;
        const int p0 = st * kKP;
        if (vec_x) {
          for (int i = lane; i < kKP * NT; i += 32) {
            const int l = i / NT, j = i - l * NT;
            const int pr = p0 + gather_k_phys<kInt4>(l);
            const int cc = c0 + 8 * j;
            const bool ok = pr < p && cc < c;
            cp_async16(base + xs + (l * LDX + 8 * j) * (int)sizeof(bf16),
                       ok ? xblk + (long long)pr * c + cc : x, ok ? 16 : 0);
          }
        } else {
          // rows that are not 16-byte aligned (C 1, 3): 8 loads a lane in
          // flight, then their stores
          constexpr int kN = kKP * NT * 8, kB = 8;
          bf16* xsp = reinterpret_cast<bf16*>(smem + xs);
          for (int i0 = lane; i0 < kN; i0 += 32 * kB) {
            bf16 v[kB];
#pragma unroll
            for (int q = 0; q < kB; ++q) {
              const int i = i0 + 32 * q;
              const int l = i / (NT * 8), k = i - l * (NT * 8);
              const int pr = p0 + gather_k_phys<kInt4>(l);
              v[q] = i < kN && pr < p && c0 + k < c
                         ? xblk[(long long)pr * c + c0 + k]
                         : __float2bfloat16_rn(0.0f);
            }
#pragma unroll
            for (int q = 0; q < kB; ++q) {
              const int i = i0 + 32 * q;
              if (i < kN) xsp[(i / (NT * 8)) * LDX + i % (NT * 8)] = v[q];
            }
          }
        }
        mbar_arrive_cp_async(full);
        mbar_arrive(full);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  // ldmatrix(.x4).trans row addresses: lane l gives row l % 8 of matrix
  // l / 8 (matrices: k 0-7 / 8-15 of n-tile 2u, then of n-tile 2u + 1)
  const int ld_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int ld_n = (lane >> 4) * 8;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long rest = tile / col_tiles;
    const int c0 = (int)(tile - rest * col_tiles) * kColTile;
    const long long blk = rest / row_tiles;
    const int row0 = (int)(rest - blk * row_tiles) * rows;
    // a warp whose rows all lie past ET takes its turns but does not multiply
    const bool active = row0 + warp * kRW < et;
    float acc[kMT][NT][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.0f;

    for (int st = 0; st < nst; ++st, ++it) {
      const int s = it % kS;
      mbar_wait(bar0 + 8 * s, (uint32_t)((it / kS) & 1));
      if (active) {
        const unsigned char* ms = smem + s * mstage + warp * kRW * kW;
        const uint32_t xs = base + xs0 + s * xstage;
#pragma unroll
        for (int ch = 0; ch < kW / 16; ++ch) {
          uint32_t w[kMT][2];   // the chunk's words of rows g, g + 8
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            const int o0 = (mi * 16 + g) * kW + ch * 16 + 4 * t;
            w[mi][0] = *reinterpret_cast<const uint32_t*>(ms + swizzle<kW>(o0));
            w[mi][1] =
                *reinterpret_cast<const uint32_t*>(ms + swizzle<kW>(o0 + 8 * kW));
          }
#pragma unroll
          for (int ks = 0; ks < kKS; ++ks) {
            uint32_t b[NT][2];
            const uint32_t brow =
                xs + ((ch * kKS + ks) * 16 + ld_k) * LDX * (int)sizeof(bf16);
            if constexpr (NT == 1) {
              asm volatile(
                  "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                  : "=r"(b[0][0]), "=r"(b[0][1])
                  : "r"(brow));
            } else {
#pragma unroll
              for (int u = 0; u < NT / 2; ++u) {
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                    "{%0, %1, %2, %3}, [%4];\n"
                    : "=r"(b[2 * u][0]), "=r"(b[2 * u][1]), "=r"(b[2 * u + 1][0]),
                      "=r"(b[2 * u + 1][1])
                    : "r"(brow + (u * 16 + ld_n) * (int)sizeof(bf16)));
              }
            }
#pragma unroll
            for (int mi = 0; mi < kMT; ++mi) {
              uint32_t a[4];
              gather_a_frag<kInt4>(w[mi][0], w[mi][1], ks, a);
#pragma unroll
              for (int nj = 0; nj < NT; ++nj)
                mma_bf16(acc[mi][nj], a, b[nj][0], b[nj][1]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar0 + 8 * (kS + s));
    }
    if (!active) continue;

    // accumulator pair (2h, 2h + 1) of tile (mi, nj): row g + 8h, columns
    // 2t, 2t + 1; a quad's float2 stores fill one 32-byte sector of a row
    float* oblk = out + blk * et * (long long)c;
    const bool pairs = c % 2 == 0;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + warp * kRW + mi * 16 + g + 8 * h;
        if (r >= et) continue;
        float* orow = oblk + (long long)r * c;
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          const int cc = c0 + nj * 8 + 2 * t;
          const float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
          if (pairs && cc + 1 < c) {
            *reinterpret_cast<float2*>(orow + cc) = make_float2(v0, v1);
          } else {
            if (cc < c) orow[cc] = v0;
            if (cc + 1 < c) orow[cc + 1] = v1;
          }
        }
      }
  }
}

template <bool kInt4, int NT>
cudaError_t launch_gather(const uint8_t* masks, const bf16* x, float* out,
                          long long bnb, int et, int p, int c, int warps,
                          int row_tiles, int smem, int device,
                          cudaStream_t stream) {
  const long long rb = kInt4 ? p / 2 : p;
  const uintptr_t mp = (uintptr_t)masks;
  const int access = rb > 0 && rb % 16 == 0 && mp % 16 == 0 ? 16
                     : rb % 4 == 0 && mp % 4 == 0 ? 4 : 1;
  CUtensorMap map = {};
  if (access == 16 &&
      !tma_ring::encode_bytes_2d(&map, masks, (unsigned long long)(bnb * et),
                                 (unsigned long long)rb, kGatherSpan,
                                 gather_cfg(NT).rows_per_warp,
                                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = mask_gather_kernel<kInt4, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int col_tiles = (c + kColTile - 1) / kColTile;
  const long long ntiles = bnb * row_tiles * col_tiles;
  const bool vec_x = c % 8 == 0 && (uintptr_t)x % 16 == 0;
  kernel<<<(unsigned)(ntiles < sms ? ntiles : sms), (warps + 1) * 32, smem,
           stream>>>(map, masks, x, out, et, p, c, row_tiles, col_tiles, ntiles,
                     access, vec_x);
  return cudaGetLastError();
}

template <bool kInt4>
cudaError_t gather_nt_launch(const uint8_t* masks, const bf16* x, float* out,
                             long long bnb, int et, int p, int c, int nt,
                             int warps, int row_tiles, int smem, int device,
                             cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_gather<kInt4, 1>(masks, x, out, bnb, et, p, c, warps, row_tiles, smem, device, stream);
    case 2: return launch_gather<kInt4, 2>(masks, x, out, bnb, et, p, c, warps, row_tiles, smem, device, stream);
    case 4: return launch_gather<kInt4, 4>(masks, x, out, bnb, et, p, c, warps, row_tiles, smem, device, stream);
    default: return launch_gather<kInt4, 8>(masks, x, out, bnb, et, p, c, warps, row_tiles, smem, device, stream);
  }
}

}  // namespace

// Kernel H.  masks (bnb, et, p) int8 (is_int4 = 0) or (bnb, et, p / 2)
// packed int4 (is_int4 = 1; p even); patches (bnb, p, c) bf16 -> out
// (bnb, et, c) f32.  The tiling comes from the wrapper (mask_kernels.
// gather_tiling): nt n8 column fragments, rows_per_warp, consumer warps
// per CTA, row_tiles per block, the ring's stages and its dynamic shared
// memory; a tiling that differs from what this kernel
// computes, or does not cover ET, is refused with cudaErrorInvalidValue,
// as is bnb * et past 2^31 - 1 (the tensor map's row coordinate).  Every
// output element is written.
extern "C" int mask_dot_gather(const void* masks, const void* x, float* out,
                               long long bnb, int et, int p, int c,
                               int is_int4, int nt, int rows_per_warp,
                               int warps, int row_tiles, int stages, int smem,
                               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnb == 0 || c == 0 || et == 0) return cudaSuccess;
  const long long rows = (long long)warps * rows_per_warp;
  const GatherCfg cfg = gather_cfg(nt);
  // nt: kernel I's column fragments for C (scatter_nt)
  if ((is_int4 && p % 2) || nt != scatter_nt(c) ||
      rows_per_warp != cfg.rows_per_warp || stages != cfg.stages || warps < 1 || warps > cfg.max_warps ||
      row_tiles < 1 || rows * row_tiles < et || rows * (row_tiles - 1) >= et ||
      bnb * et > 0x7fffffffLL ||
      (size_t)smem != gather_smem_bytes(nt, (int)rows, is_int4)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* m = (const uint8_t*)masks;
  const bf16* xv = (const bf16*)x;
  err = is_int4 ? gather_nt_launch<true>(m, xv, out, bnb, et, p, c, nt, warps,
                                         row_tiles, smem, device, stream)
                : gather_nt_launch<false>(m, xv, out, bnb, et, p, c, nt, warps,
                                          row_tiles, smem, device, stream);
  return (int)err;
}

// Kernel I.  masks as for H; edges (bnb, et, c) bf16 -> out (bnb, p, c)
// f32.  The tiling comes from the wrapper (mask_kernels.scatter_tiling):
// nt n8 column fragments, rows_per_warp, warps per CTA, row_tiles per
// block and the ring's shared memory; a tiling that differs from what
// this kernel computes, or does not cover P, is refused with
// cudaErrorInvalidValue.  Every output element is written.
extern "C" int mask_dot_scatter(const void* masks, const void* x, float* out,
                                long long bnb, int et, int p, int c,
                                int is_int4, int nt, int rows_per_warp,
                                int warps, int row_tiles, int smem, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnb == 0 || c == 0 || p == 0) return cudaSuccess;
  const long long rows = (long long)warps * rows_per_warp;
  const ScatterCfg cfg = scatter_cfg(is_int4, nt);
  if ((is_int4 && p % 2) || nt != scatter_nt(c) ||
      rows_per_warp != cfg.rows_per_warp || warps < 1 ||
      warps > cfg.max_warps || row_tiles < 1 || rows * row_tiles < p ||
      rows * (row_tiles - 1) >= p ||
      (size_t)smem != scatter_smem_bytes(nt, (int)rows, is_int4)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* m = (const uint8_t*)masks;
  const bf16* xv = (const bf16*)x;
  err = is_int4 ? scatter_nt<true>(m, xv, out, bnb, et, p, c, nt, warps,
                                   row_tiles, smem, stream)
                : scatter_nt<false>(m, xv, out, bnb, et, p, c, nt, warps,
                                    row_tiles, smem, stream);
  return (int)err;
}
