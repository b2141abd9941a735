// Kernel J: the fused layer-boundary op.
//
// Replaces nbody_tpu/ops/pallas/fused_kernels.py : fused_boundary_dot
// (_fused_kernel).  For every (batch, block) with one-hot masks M (ET, P)
// (ops/blocked.block_masks) and the block's patches (P, C), cast to the
// masks' dtype by the wrapper as boundary_reference casts them:
//   e   = relu(M . patches + a_edge)          f32
//   act = e in the patches' dtype              (ET, C)
//   h1  = rw(e) . W1                           (ET, q) f32
//   hw  = rm(rw(e) . W2)                       (ET, q)
//   s   = M^T . hw                             (P, q)  f32
// rw / rm round to the weights' / the masks' dtype (identity for f32).  J
// exists to read every mask tile once for both products.
//
// What bounds it on the H100: at the bench_fused shapes (32^3 b4 K14, core
// (4,8,8): masks (4, 128, 3328, 1152) bf16, C = q = 32) one call moves
// 4.47 GB, 3.93 GB of it mask, for 258 GFLOP on the tensor cores: the
// mask stream (1.34 ms at 3.35 TB/s) against 0.26 ms of products.
//
// bf16 masks (fused_boundary_kernel): a cluster of k CTAs (k = 1, 2 or 4)
// takes a block; CTA r owns the P columns [r * p_cta, (r + 1) * p_cta),
// p_cta a multiple of 64.  Persistent clusters walk the blocks, each its
// blocks' R-row tiles of ET in order (R 16 or 32).  Per CTA:
//   * a producer warp streams the CTA's columns of each row tile through a
//     TMA ring (csrc/tma_ring.cuh: full / empty mbarriers, 2-4 stages):
//     3D boxes of 64 columns (128 bytes a row, swizzled by 128) x R rows
//     of one block, rows past ET and columns past P arriving as zeros, L2
//     promotion 128 B and an evict-normal policy (kernel H's lessons);
//   * consumer warp w owns MT m16 tiles of the CTA's columns for the
//     whole block: its rows of s as mma.sync accumulators in registers
//     (s goes to global memory once, when the block ends), and its rows of
//     the patches as B fragments in registers, loaded once per block;
//   * M . patches (mma.sync m16n8k16 bf16 -> f32): each consumer warp
//     multiplies the tile's rows by its own columns (A from the stage by
//     ldmatrix), so each gives a partial (R, C) sum.  The warps' partials
//     meet in shared memory and are summed in warp order; CTA r of the
//     cluster owns rows [r R / k, (r + 1) R / k) of every tile, and each
//     CTA's sum of those rows goes to CTA r in one bulk copy through
//     distributed shared memory, completing on CTA r's mbarrier;
//   * one or two chain warps run the per-edge chain of the CTA's rows,
//     while the consumers multiply the next tile, in short loops over
//     shared memory: they sum the cluster's sums in rank order, add
//     a_edge (fetched two tiles ahead by cp.async), store act and keep
//     rw(e) as an act tile, whose rows are the A fragments (ldmatrix) of
//     the weight products on the tensor cores for bf16 weights (W1 and W2
//     staged in shared memory once; C and q padded with zeros to a
//     multiple of 16), in f32 on the CUDA cores otherwise; they store h1,
//     and the rows of hw (bf16) go to every CTA of the cluster in one bulk
//     copy each;
//   * s += M^T . hw reads the same stage through ldmatrix.trans, hw's B
//     fragments through ldmatrix.trans; then the stage goes back to the
//     producer.
// The tile loop has no __syncthreads: stages move through the ring's
// mbarriers, the consumers' partials through two named barriers, and the
// cluster exchange through double-buffered mbarriers armed a phase ahead
// with the bytes they expect.  A consumer warp multiplies tile i + 1's
// M . patches before tile i's M^T . hw, so that the chain and the
// exchange hide behind the products.  The registers set the warps: a
// consumer's s and patch fragments take at most 96 of its 168 (12 warps
// a CTA), which sets the m16 tiles it owns; the chain has a warp of its
// own (in the consumers, its fragments spilled).
//
// What holds it back (variant and per-section timings, PERF.md §6): not
// the stream.  A 32-row tile
// costs the consumers ~3.2 us against the ring's 1.5 at the bench shape,
// in two latency-bound mma.sync passes and the cross-warp sum; in clusters
// of 4 each CTA walks twice the tiles and one chain warp falls behind.
//
// Exactness: products of bf16 operands are exact on the tensor cores, so
// the one-hot M . patches is exact; h1 and s may differ from the plain
// version only by the order of their f32 sums.  Every sum across warps or
// CTAs has a fixed order and nothing is atomic: two launches give the same
// bits.  Shapes: P a multiple of 8 (the tensor map's row pitch), C and q at
// most 64; the Python wrapper chooses the tiling (fused_tiling), the entry
// checks it and refuses one that does not fit.
//
// f32 masks (fused_boundary_f32_kernel) keep the CUDA-core form for exact
// f32 products: one CTA of 1024 threads per block walking 16-edge row
// tiles, the block's whole s (P, q) f32 in shared memory, the patches read
// through L2.  It is slower than its plain version (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

// variant switches (PERF.md §6 has the timings with them off):
// the patch B fragments held in registers for a block, or read through L2
// at every tile; the two mask products, or none of them (the ring, the
// exchange and the chain alone)
#define FUSED_PATCH_FRAGS_IN_REGISTERS 1
#define FUSED_PRODUCTS 1

namespace {

typedef __nv_bfloat16 bf16;

const int kMaxWarps = 12;      // warps of a CTA at most (168 registers each)
const int kBoxCols = 64;       // mask columns of a TMA box: 128 bytes a row
const int kMaxCluster = 4;     // CTAs of a cluster at most
const int kSmemAlign = 1024;   // the 128-byte swizzle's atom

// n8 tiles of C or q: 2, 4 or 8 (16 columns at least, for the k16 steps
// of the weight products and the x4 ldmatrix of their B fragments)
__host__ __device__ constexpr int col_tiles(int n) {
  return n <= 16 ? 2 : n <= 32 ? 4 : 8;
}

// m16 tiles of P a consumer warp owns at NC n8 tiles of C and NQ of q: its
// s accumulators (4 NQ a tile) and patch fragments (2 NC a tile) take at
// most 96 registers a thread
__host__ __device__ constexpr int fused_mt(int nc, int nq) {
  return 96 / (4 * nq + 2 * nc) > 12 ? 12 : 96 / (4 * nq + 2 * nc);
}

// m16 row tiles of ET in a stage at most (the M . patches accumulators)
__host__ __device__ constexpr int fused_max_rt(int nc) { return nc == 8 ? 1 : 2; }

__host__ __device__ inline int align16i(int n) { return (n + 15) & ~15; }

// byte offsets of the dynamic shared memory, after the alignment slack:
// the ring, the warps' partials (R x LDE f32 each), the CTA's sums on
// their way out (2 slots x R x LDE f32), the cluster's sums of this CTA's
// rows (2 slots x k x R / k x LDE f32), hw of this CTA's rows on its way out
// (2 slots x R x LDH bf16), hw arrived (the same), the chain's act tile
// (R x (C8 + 8) x 4 bytes: bf16 rows, or f32 ones), its a_edge (2 slots x
// R x C8 x 4 bytes), W1 and W2 (KC x LDW each) and the mbarriers
struct FusedLayout {
  int stage_bytes, partial, e_out, e_in, hw_out, hw_in, act_s, ae_s, wsm, bars, total;
};

__host__ __device__ inline FusedLayout fused_layout(int nc, int nq, int rows,
                                                    int stages, int cluster,
                                                    int warps, int p_cta,
                                                    bool w_bf16) {
  const int lde = nc * 8 + 8, ldh = nq * 8 + 8;
  const int kc = nc / 2 * 16;
  const int ldw = w_bf16 ? ldh : nq * 8;
  FusedLayout l;
  l.stage_bytes = p_cta / kBoxCols * rows * 128;
  l.partial = stages * l.stage_bytes;
  l.e_out = l.partial + warps * rows * lde * 4;
  l.e_in = l.e_out + 2 * rows * lde * 4;
  l.hw_out = l.e_in + 2 * rows * lde * 4;
  l.hw_in = l.hw_out + 2 * rows * ldh * 2;
  l.act_s = l.hw_in + 2 * rows * ldh * 2;
  l.ae_s = l.act_s + rows * (nc * 8 + 8) * 4;
  l.wsm = l.ae_s + 2 * rows * nc * 8 * 4;
  l.bars = l.wsm + align16i(2 * kc * ldw * (w_bf16 ? 2 : 4));
  l.total = kSmemAlign + l.bars + (2 * stages + 4) * 8;
  return l;
}

struct FusedArgs {
  long long bnb;
  int et, p, c, q;
  int rows, stages, cluster, warps, chains, p_cta;
  int a_bf16, w_bf16, act_bf16;
  int ae_async;   // a_edge rows in 4-byte aligned pairs: prefetched by cp.async
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_any(const void* base, long long i,
                                          bool is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(base)[i])
                 : reinterpret_cast<const float*>(base)[i];
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the shared::cluster address of `addr` (this CTA's) in CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 2 elements of elem bytes (4 or 8 bytes, aligned) from global memory into
// shared memory, zeros where !ok
__device__ __forceinline__ void cp_async_pair(uint32_t dst, const void* src,
                                              int elem, bool ok) {
  if (elem == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's shared-memory writes visible to the async proxy
// (a bulk copy that reads them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes of this CTA's shared memory at src into the shared memory of a CTA
// of the cluster at dst, completing on that CTA's mbarrier bar (dst and
// bar from mapa)
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src,
                                                  uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int NC, int NQ>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
fused_boundary_kernel(const __grid_constant__ CUtensorMap map,
                      const bf16* __restrict__ patches,
                      const void* __restrict__ a_edge,
                      const float* __restrict__ w1,
                      const float* __restrict__ w2, void* __restrict__ act,
                      float* __restrict__ h1, float* __restrict__ s_out,
                      const FusedArgs args) {
  using namespace tma_ring;
  constexpr int MT = fused_mt(NC, NQ);
  constexpr int kRT = fused_max_rt(NC);
  constexpr int C8 = NC * 8, Q8 = NQ * 8;
  constexpr int LDE = C8 + 8, LDH = Q8 + 8;
  constexpr int KS = NC / 2;                   // k16 steps of the weight products

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw_s + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1);
  unsigned char* const smem = smem_raw + (base - raw_s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int W = args.warps, R = args.rows, rt = R / 16, S = args.stages;
  const int ncw = args.chains;                 // chain warps
  const int k = args.cluster, et = args.et, c = args.c, q = args.q;
  const bool wb = args.w_bf16;
  const FusedLayout L = fused_layout(NC, NQ, R, S, k, W, args.p_cta, wb);
  const uint32_t full0 = base + L.bars, empty0 = full0 + 8 * S;
  const uint32_t efull0 = empty0 + 8 * S, hwfull0 = efull0 + 16;
  const uint32_t rank = cluster_rank();
  const int cid = (int)cluster_id(), ncl = (int)cluster_count();
  const int p_begin = (int)rank * args.p_cta;
  const int p_end = min(args.p, p_begin + args.p_cta);
  const int nbox = p_end > p_begin ? (p_end - p_begin + kBoxCols - 1) / kBoxCols : 0;
  const int tpb = (et + R - 1) / R;            // row tiles a block
  // tiles this cluster walks (the entry keeps the count an int); 32-bit
  // tile arithmetic, as 64-bit division is a long software routine
  const int nblk = args.bnb > cid ? (int)((args.bnb - cid + ncl - 1) / ncl) : 0;
  const int T = nblk * tpb;
  // bytes that complete e_full (every CTA's sum of a tile) and hw_full
  const uint32_t e_tile = (uint32_t)(R * LDE * 4), hw_tile = (uint32_t)(R * LDH * 2);
  const uint32_t e_bytes = e_tile, hw_bytes = hw_tile;

  // full[s]: the producer's arrival and the stage's bytes; empty[s]: one
  // per consumer warp; e_full[j] and hw_full[j] (tiles of parity j): one
  // arrival with the bytes the cluster's bulk copies bring, armed a phase
  // ahead
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, W);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(efull0 + 8 * j, 1);
      mbar_init(hwfull0 + 8 * j, 1);
    }
    mbar_fence_init();
    for (int j = 0; j < 2; ++j) {
      if (j < T) mbar_arrive_expect_tx(efull0 + 8 * j, e_bytes);
      if (j < T) mbar_arrive_expect_tx(hwfull0 + 8 * j, hw_bytes);
    }
  }
  // W1 and W2 into shared memory once, zeros past C and q: bf16 weights as
  // bf16 [KS * 16][LDH] (ldmatrix rows), f32 weights as f32 [KS * 16][Q8]
  {
    const int kc = KS * 16, ldw = wb ? LDH : Q8;
    for (int i = tid; i < 2 * kc * Q8; i += blockDim.x) {
      const int m = i / (kc * Q8), r = (i / Q8) % kc, j = i % Q8;
      const float v = r < c && j < q ? (m ? w2 : w1)[r * q + j] : 0.0f;
      if (wb) {
        reinterpret_cast<bf16*>(smem + L.wsm)[(m * kc + r) * ldw + j] =
            __float2bfloat16_rn(v);
      } else {
        reinterpret_cast<float*>(smem + L.wsm)[(m * kc + r) * ldw + j] = v;
      }
    }
  }
  __syncthreads();
  cluster_sync();   // every CTA's barriers exist before any remote store

  // ldmatrix lane roles.  A of M . patches (rows e, k = p): matrix l / 8
  // holds rows + 8 ((l / 8) & 1), 16-byte granule + l / 16.  A of M^T . hw
  // (.trans; rows p, k = e): rows + 8 (l / 16), granule + (l / 8) & 1.  B of
  // a row-major [k][n] tile (.trans): row ld_k, column ld_n.
  const int ld_k = ((lane >> 3) & 1) * 8 + (lane & 7), ld_n = (lane >> 4) * 8;

  if (warp == W + ncw) {
    // the producer: the CTA's columns of each row tile, box by box
    if (lane == 0) {
      uint64_t policy;
      asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                   : "=l"(policy));
      for (int i = 0; i < T; ++i) {
        const int s = i % S;
        mbar_wait(empty0 + 8 * s, (uint32_t)((i / S) & 1) ^ 1u);
        const long long blk = cid + (long long)(i / tpb) * ncl;
        const int row0 = (i % tpb) * R;
        mbar_arrive_expect_tx(full0 + 8 * s, (uint32_t)(nbox * R * 128));
        for (int bx = 0; bx < nbox; ++bx) {
          tma_load_3d(base + s * L.stage_bytes + bx * R * 128, &map,
                      p_begin + bx * kBoxCols, row0, (int)blk, full0 + 8 * s,
                      policy);
        }
      }
    }
    __syncwarp();
  } else if (warp >= W) {
    // the chain warps: the per-edge chain of this CTA's rows of every tile
    // (rows [rank R / k, (rank + 1) R / k) of the tile; chain warp cw takes
    // rows_cw of them and the row groups cw, cw + ncw, ... of the weight
    // products), in short loops over shared memory, so that the code a
    // warp runs for a tile stays small
    const int cw = warp - W, rows_r = R / k, rows_cw = rows_r / ncw;
    const int r0 = cw * rows_cw;               // the warp's first row of the CTA's
    const int rgs = (rows_r + 15) / 16;        // m16 row groups of the products
    const int ldc = C8 + 8;                    // bf16 per row of the act tile
    bf16* __restrict__ act_b = reinterpret_cast<bf16*>(smem + L.act_s);
    float* __restrict__ act_f = reinterpret_cast<float*>(smem + L.act_s);
    const float* wf1 = reinterpret_cast<const float*>(smem + L.wsm);
    const float* wf2 = wf1 + KS * 16 * Q8;
    const uint32_t wsm1 = base + L.wsm, wsm2 = wsm1 + KS * 16 * LDH * 2;
    const int ae_elem = args.a_bf16 ? 2 : 4;
    // a_edge of the warp's rows of tile i into slot i & 1, two tiles ahead
    // (cp.async, zeros past ET and C; rows not 4-byte aligned as pairs are
    // read at their use instead)
    auto fetch_a = [&](int i) {
      if (args.ae_async && i < T) {
        const long long blk = cid + (long long)(i / tpb) * ncl;
        const int grow0 = (i % tpb) * R + (int)rank * rows_r;
        const uint32_t slot = base + L.ae_s + (i & 1) * R * C8 * 4;
        for (int x = lane; x < rows_cw * C8 / 2; x += 32) {
          const int row = r0 + x / (C8 / 2), col = 2 * (x % (C8 / 2));
          const bool ok = grow0 + row < et && col < c;
          const char* src = reinterpret_cast<const char*>(a_edge) +
                            ((blk * et + grow0 + row) * (long long)c + col) * ae_elem;
          cp_async_pair(slot + (row * C8 + col) * ae_elem,
                        ok ? src : reinterpret_cast<const char*>(a_edge), ae_elem,
                        ok);
        }
      }
      cp_async_commit();
    };
    fetch_a(0);
    fetch_a(1);
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
      const int slot = i & 1;
      const long long blk = cid + (long long)(i / tpb) * ncl;
      const int grow0 = (i % tpb) * R + (int)rank * rows_r;   // ET row of row 0
      cp_async_wait<1>();                    // this tile's a_edge landed
      __syncwarp();
      mbar_wait(efull0 + 8 * slot, (uint32_t)((i >> 1) & 1));
      // the k CTAs' sums of these rows, [x][rows_r][LDE] in rank order x
      // (restrict: the act tile's stores do not alias these reads, so that
      // the compiler may issue a row's loads before the last row's stores)
      const float* __restrict__ ein =
          reinterpret_cast<const float*>(smem + L.e_in) + slot * R * LDE;
      const unsigned char* __restrict__ aes = smem + L.ae_s + slot * R * C8 * 4;
      // e = relu(the cluster's sums in rank order + a_edge): act out, and
      // rw(e) into the act tile; rows past ET and columns past C give 0
#pragma unroll 4
      for (int x = lane; x < rows_cw * C8 / 2; x += 32) {
        const int row = r0 + x / (C8 / 2), col = 2 * (x % (C8 / 2));
        const int er = grow0 + row;
        float2 u[kMaxCluster];
#pragma unroll
        for (int y = 0; y < kMaxCluster; ++y) {
          if (y < k) {
            u[y] = *reinterpret_cast<const float2*>(ein + (y * rows_r + row) * LDE + col);
          }
        }
        float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
        for (int y = 0; y < kMaxCluster; ++y) {
          if (y < k) {
            v0 += u[y].x;
            v1 += u[y].y;
          }
        }
        const long long o = (blk * et + er) * (long long)c + col;
        if (args.ae_async) {
          v0 += ae_elem == 2 ? __bfloat162float(reinterpret_cast<const bf16*>(aes)[row * C8 + col])
                             : reinterpret_cast<const float*>(aes)[row * C8 + col];
          v1 += ae_elem == 2 ? __bfloat162float(reinterpret_cast<const bf16*>(aes)[row * C8 + col + 1])
                             : reinterpret_cast<const float*>(aes)[row * C8 + col + 1];
        } else if (er < et) {
          if (col < c) v0 += load_any(a_edge, o, args.a_bf16);
          if (col + 1 < c) v1 += load_any(a_edge, o + 1, args.a_bf16);
        }
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
        if (er < et && col < c) {
          if (args.act_bf16) {
            bf16* ap = reinterpret_cast<bf16*>(act) + o;
            if (col + 1 < c && c % 2 == 0) {
              *reinterpret_cast<uint32_t*>(ap) = pack_bf16(v0, v1);
            } else {
              ap[0] = __float2bfloat16_rn(v0);
              if (col + 1 < c) ap[1] = __float2bfloat16_rn(v1);
            }
          } else {
            float* ap = reinterpret_cast<float*>(act) + o;
            if (col + 1 < c && c % 2 == 0) {
              *reinterpret_cast<float2*>(ap) = make_float2(v0, v1);
            } else {
              ap[0] = v0;
              if (col + 1 < c) ap[1] = v1;
            }
          }
        }
        if (wb) {
          *reinterpret_cast<uint32_t*>(act_b + row * ldc + col) = pack_bf16(v0, v1);
        } else {
          *reinterpret_cast<float2*>(act_f + row * C8 + col) = make_float2(v0, v1);
        }
      }
      if (ncw > 1) {
        named_sync(2, ncw * 32);   // the act tile is whole
      } else {
        __syncwarp();
      }
      bf16* hwo = reinterpret_cast<bf16*>(smem + L.hw_out) + slot * R * LDH;
      if (wb) {
        // h1 = act . W1 and hw = act . W2 on the tensor cores: A from the
        // act tile and W's B fragments by ldmatrix, 16 rows at a time (rows
        // of the last group past rows_r are not stored)
        const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
#pragma unroll 1
        for (int rg = cw; rg < rgs; rg += ncw) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            float acc[NQ][4];
#pragma unroll
            for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[nq][r] = 0.0f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              uint32_t a[4];
              ldsm_x4(base + L.act_s +
                          ((rg * 16 + a_row) * ldc + ks * 16 + a_col) * 2,
                      a);
#pragma unroll
              for (int u = 0; u < NQ / 2; ++u) {
                uint32_t b[4];
                ldsm_x4_t((m ? wsm2 : wsm1) +
                              ((ks * 16 + ld_k) * LDH + u * 16 + ld_n) * 2,
                          b[0], b[1], b[2], b[3]);
                mma_bf16(acc[2 * u], a, b[0], b[1]);
                mma_bf16(acc[2 * u + 1], a, b[2], b[3]);
              }
            }
#pragma unroll
            for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = rg * 16 + g + 8 * h, col = nq * 8 + 2 * t;
                const float v0 = acc[nq][2 * h], v1 = acc[nq][2 * h + 1];
                if (row >= rows_r) continue;
                if (m) {
                  *reinterpret_cast<uint32_t*>(hwo + row * LDH + col) =
                      pack_bf16(v0, v1);
                } else if (grow0 + row < et && col < q) {
                  float* hp = h1 + (blk * et + grow0 + row) * (long long)q + col;
                  if (col + 1 < q && q % 2 == 0) {
                    *reinterpret_cast<float2*>(hp) = make_float2(v0, v1);
                  } else {
                    hp[0] = v0;
                    if (col + 1 < q) hp[1] = v1;
                  }
                }
              }
          }
        }
      } else {
        // f32 weights on the CUDA cores, one output of h1 and of hw a lane
#pragma unroll 1
        for (int x = lane; x < rows_cw * Q8; x += 32) {
          const int row = r0 + x / Q8, jq = x % Q8;
          float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 1
          for (int cc = 0; cc < C8; ++cc) {
            const float ev = act_f[row * C8 + cc];
            s1 = fmaf(ev, wf1[cc * Q8 + jq], s1);
            s2 = fmaf(ev, wf2[cc * Q8 + jq], s2);
          }
          if (grow0 + row < et && jq < q) {
            h1[(blk * et + grow0 + row) * (long long)q + jq] = s1;
          }
          hwo[row * LDH + jq] = __float2bfloat16_rn(s2);
        }
      }
      // these rows of hw to every CTA of the cluster, one bulk copy each
      fence_proxy_async();
      if (ncw > 1) {
        named_sync(2, ncw * 32);
      } else {
        __syncwarp();
      }
      if (cw == 0 && lane == 0) {
        const uint32_t bytes = (uint32_t)(rows_r * LDH * 2);
        const uint32_t src = base + L.hw_out + slot * hw_tile;
        const uint32_t dst = base + L.hw_in + slot * hw_tile + (int)rank * bytes;
        for (int x = 0; x < k; ++x) {
          bulk_copy_cluster(mapa(dst, (uint32_t)x), src, bytes,
                            mapa(hwfull0 + 8 * slot, (uint32_t)x));
        }
        if (i + 2 < T) mbar_arrive_expect_tx(efull0 + 8 * slot, e_bytes);
      }
      fetch_a(i + 2);
    }
    cp_async_wait<0>();
  } else {
    const int mt0 = warp * MT;   // the warp's first m16 tile of the CTA's columns
    const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_gran = lane >> 4;
    const int t_row = (lane & 7) + 8 * (lane >> 4), t_gran = (lane >> 3) & 1;
    const int nthreads = W * 32;

    float sacc[MT][NQ][4];
    uint32_t pb[MT][NC][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
        for (int r = 0; r < 4; ++r) sacc[mi][nq][r] = 0.0f;

    // the stage's 16-byte granule of row `row`, for m16 tile mi of the warp
    auto mask_addr = [&](int s, int row, int mi, int gran) -> uint32_t {
      const int tile = mt0 + mi;
      const int gr = ((tile & 3) << 1) + gran;
      return base + s * L.stage_bytes + (tile >> 2) * R * 128 + row * 128 +
             ((gr ^ (row & 7)) << 4);
    };
    auto tile_live = [&](int mi) { return p_begin + (mt0 + mi) * 16 < p_end; };
    // B fragment h of the patches at m16 tile mi, n8 tile nj: rows
    // 2t (+1) (+8h) of the tile, column 8nj + g; zeros past the CTA's
    // columns and past C
    auto patch_frag = [&](long long blk, int mi, int nj, int h) -> uint32_t {
      const bf16* pblk = patches + blk * (long long)args.p * c;
      const int pr = p_begin + (mt0 + mi) * 16 + 2 * t + 8 * h;
      const int cc = nj * 8 + g;
      const bf16 z = __float2bfloat16_rn(0.0f);
      __nv_bfloat162 v;
      v.x = pr < p_end && cc < c ? pblk[(long long)pr * c + cc] : z;
      v.y = pr + 1 < p_end && cc < c ? pblk[(long long)(pr + 1) * c + cc] : z;
      return *reinterpret_cast<const uint32_t*>(&v);
    };
    auto load_patches = [&](long long blk) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < NC; ++nj)
#pragma unroll
          for (int h = 0; h < 2; ++h) pb[mi][nj][h] = patch_frag(blk, mi, nj, h);
    };

    // tile i1's M . patches over the warp's columns; the partials summed
    // over the warps in order, and each CTA's rows of the sum copied to it
    // in one bulk copy, completing on its e_full
    auto gather_partial = [&](int i1) {
      const int s = i1 % S;
      mbar_wait(full0 + 8 * s, (uint32_t)((i1 / S) & 1));
      float eacc[kRT][NC][4];
#pragma unroll
      for (int ei = 0; ei < kRT; ++ei)
#pragma unroll
        for (int nj = 0; nj < NC; ++nj)
#pragma unroll
          for (int r = 0; r < 4; ++r) eacc[ei][nj][r] = 0.0f;
#if FUSED_PRODUCTS
#if !FUSED_PATCH_FRAGS_IN_REGISTERS
      const long long blk1 = cid + (long long)(i1 / tpb) * ncl;
#endif
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (!tile_live(mi)) continue;
#pragma unroll
        for (int ei = 0; ei < kRT; ++ei) {
          if (ei >= rt) continue;
          uint32_t a[4];
          ldsm_x4(mask_addr(s, ei * 16 + a_row, mi, a_gran), a);
#pragma unroll
          for (int nj = 0; nj < NC; ++nj) {
#if FUSED_PATCH_FRAGS_IN_REGISTERS
            mma_bf16(eacc[ei][nj], a, pb[mi][nj][0], pb[mi][nj][1]);
#else
            mma_bf16(eacc[ei][nj], a, patch_frag(blk1, mi, nj, 0),
                     patch_frag(blk1, mi, nj, 1));
#endif
          }
        }
      }
#endif
      float* part = reinterpret_cast<float*>(smem + L.partial) + warp * R * LDE;
#pragma unroll
      for (int ei = 0; ei < kRT; ++ei) {
        if (ei >= rt) continue;
#pragma unroll
        for (int nj = 0; nj < NC; ++nj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<float2*>(
                part + (ei * 16 + g + 8 * h) * LDE + nj * 8 + 2 * t) =
                make_float2(eacc[ei][nj][2 * h], eacc[ei][nj][2 * h + 1]);
          }
      }
      named_sync(1, nthreads);
      float* __restrict__ eo =
          reinterpret_cast<float*>(smem + L.e_out) + (i1 & 1) * R * LDE;
      const float* __restrict__ parts = reinterpret_cast<const float*>(smem + L.partial);
      // four columns a thread, the warps' loads unrolled so that they are
      // in flight together
      for (int x = tid; x < R * C8 / 4; x += nthreads) {
        const int row = x / (C8 / 4), col = 4 * (x % (C8 / 4));
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 5
        for (int w = 0; w < W; ++w) {
          const float4 u =
              *reinterpret_cast<const float4*>(parts + (w * R + row) * LDE + col);
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        *reinterpret_cast<float4*>(eo + row * LDE + col) = v;
      }
      fence_proxy_async();
      named_sync(1, nthreads);   // the sum is whole; the partials are free
      // each CTA's rows of the sum to that CTA, one bulk copy each;
      // e_out's slot is written again two tiles on, after this CTA's wait
      // for tile i1's hw, which comes only after the copies landed
      if (tid == 0) {
        const int rows_r = R / k;
        const uint32_t bytes = (uint32_t)(rows_r * LDE * 4);
        const uint32_t src = base + L.e_out + (i1 & 1) * e_tile;
        const uint32_t dst = base + L.e_in + (i1 & 1) * e_tile + (int)rank * bytes;
        for (int x = 0; x < k; ++x) {
          bulk_copy_cluster(mapa(dst, (uint32_t)x), src + x * bytes, bytes,
                            mapa(efull0 + 8 * (i1 & 1), (uint32_t)x));
        }
      }
    };

    // s += M^T . hw over tile i; then the stage goes back to the producer
    auto scatter = [&](int i) {
      const int s = i % S;
      mbar_wait(hwfull0 + 8 * (int)(i & 1), (uint32_t)((i >> 1) & 1));
#if FUSED_PRODUCTS
      const uint32_t hwb = base + L.hw_in + (int)(i & 1) * R * LDH * 2;
#pragma unroll
      for (int ei = 0; ei < kRT; ++ei) {
        if (ei >= rt) continue;
        uint32_t b[NQ][2];
#pragma unroll
        for (int u = 0; u < NQ / 2; ++u) {
          ldsm_x4_t(hwb + ((ei * 16 + ld_k) * LDH + u * 16 + ld_n) * 2,
                    b[2 * u][0], b[2 * u][1], b[2 * u + 1][0], b[2 * u + 1][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (!tile_live(mi)) continue;
          uint32_t a[4];
          ldsm_x4_t(mask_addr(s, ei * 16 + t_row, mi, t_gran), a[0], a[1], a[2], a[3]);
#pragma unroll
          for (int nq = 0; nq < NQ; ++nq) mma_bf16(sacc[mi][nq], a, b[nq][0], b[nq][1]);
        }
      }
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      // hw_full's next phase in this slot is tile i + 2's; its stores come
      // only after this CTA sent its sums of tile i + 2, which every
      // consumer warp reaches after this scatter
      if (tid == 0 && i + 2 < T) mbar_arrive_expect_tx(hwfull0 + 8 * (int)(i & 1), hw_bytes);
    };

    // the block's s rows of this warp, once, and zeros for the next block
    auto store_s = [&](long long blk) {
      float* sb = s_out + blk * (long long)args.p * q;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pr = p_begin + (mt0 + mi) * 16 + g + 8 * h;
#pragma unroll
          for (int nq = 0; nq < NQ; ++nq) {
            const int col = nq * 8 + 2 * t;
            const float v0 = sacc[mi][nq][2 * h], v1 = sacc[mi][nq][2 * h + 1];
            sacc[mi][nq][2 * h] = sacc[mi][nq][2 * h + 1] = 0.0f;
            if (pr >= p_end || col >= q) continue;
            float* sp = sb + (long long)pr * q + col;
#if FUSED_PRODUCTS
            if (col + 1 < q && q % 2 == 0) {
              *reinterpret_cast<float2*>(sp) = make_float2(v0, v1);
            } else {
              sp[0] = v0;
              if (col + 1 < q) sp[1] = v1;
            }
#endif
          }
        }
    };

    if (T > 0) {
      load_patches(cid);
      gather_partial(0);
    }
    for (int i = 0; i < T; ++i) {
      if (i + 1 < T) {
        if ((i + 1) % tpb == 0) load_patches(cid + (long long)((i + 1) / tpb) * ncl);
        gather_partial(i + 1);
      }
      scatter(i);
      if (i % tpb == tpb - 1) store_s(cid + (long long)(i / tpb) * ncl);
    }
  }
  __syncwarp();
  cluster_sync();   // no CTA leaves while the others may still write to it
}

// one persistent cluster per block at most, as many as the card holds at once
template <int NC, int NQ>
cudaError_t launch_tc(const CUtensorMap& map, const void* patches,
                      const void* a_edge, const float* w1, const float* w2,
                      void* act, float* h1, float* s, const FusedArgs& args,
                      int smem, cudaStream_t stream) {
  auto kernel = fused_boundary_kernel<NC, NQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)args.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)args.cluster);
  cfg.blockDim = dim3((unsigned)(args.warps + args.chains + 1) * 32);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const long long n = args.bnb < clusters ? args.bnb : clusters;
  cfg.gridDim = dim3((unsigned)(n * args.cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, map, (const bf16*)patches, a_edge, w1,
                           w2, act, h1, s, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 masks: the CUDA-core form
// ---------------------------------------------------------------------------

const int kF32Threads = 1024;
const int kF32Rows = 16;   // edges per row tile

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t f32_smem_bytes(int p, int c, int q) {
  return align16(sizeof(float) * (size_t)p * q) +
         align16(sizeof(float) * kF32Rows * (size_t)p) +
         sizeof(float) * (size_t)kF32Rows * (c + q);
}

__global__ void __launch_bounds__(kF32Threads)
fused_boundary_f32_kernel(const float* __restrict__ masks,
                          const float* __restrict__ patches,
                          const void* __restrict__ a_edge,
                          const float* __restrict__ w1,
                          const float* __restrict__ w2, void* __restrict__ act,
                          float* __restrict__ h1, float* __restrict__ s_out,
                          int et, int p, int c, int q, bool a_bf16, bool w_bf16,
                          bool act_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_acc = reinterpret_cast<float*>(smem);                       // [P][q]
  float* mt = reinterpret_cast<float*>(smem + align16(sizeof(float) * (size_t)p * q));
  float* et_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(mt) +
      align16(sizeof(float) * (size_t)kF32Rows * p));                  // [R][C]
  float* hw_s = et_s + kF32Rows * c;                                   // [R][q]

  const long long blk = blockIdx.x;
  const int tid = threadIdx.x;
  const float* mblk = masks + blk * et * (long long)p;
  const float* pblk = patches + blk * p * (long long)c;
  const long long ebase = blk * et;               // first edge row of block
  const int row_segs = (int)(sizeof(float) * p / 16);
  const bool vec = (sizeof(float) * p) % 16 == 0 && (uintptr_t)masks % 16 == 0;

  for (int i = tid; i < p * q; i += kF32Threads) s_acc[i] = 0.0f;

  for (int e0 = 0; e0 < et; e0 += kF32Rows) {
    const int nr = min(kF32Rows, et - e0);
    // the 16-row mask tile, read once for both products
    if (vec) {
      for (int i = tid; i < kF32Rows * row_segs; i += kF32Threads) {
        const int r = i / row_segs;
        const int j = i - r * row_segs;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (r < nr) {
          u = __ldcs(reinterpret_cast<const uint4*>(mblk + (long long)(e0 + r) * p) + j);
        }
        reinterpret_cast<uint4*>(mt + (long long)r * p)[j] = u;
      }
    } else {
      for (int i = tid; i < kF32Rows * p; i += kF32Threads) {
        const int r = i / p;
        mt[i] = r < nr ? mblk[(long long)e0 * p + i] : 0.0f;
      }
    }
    __syncthreads();

    // e = relu(M . patches + a): act out, rw(e) kept in shared memory
    for (int o = tid; o < nr * c; o += kF32Threads) {
      const int r = o / c;
      const int cc = o - r * c;
      const float* mrow = mt + r * p;
      float acc = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < p; ++kk) {
        acc = fmaf(mrow[kk], pblk[(long long)kk * c + cc], acc);
      }
      const long long gi = (ebase + e0 + r) * c + cc;
      const float v = fmaxf(acc + load_any(a_edge, gi, a_bf16), 0.0f);
      if (act_bf16) {
        reinterpret_cast<bf16*>(act)[gi] = __float2bfloat16_rn(v);
      } else {
        reinterpret_cast<float*>(act)[gi] = v;
      }
      et_s[o] = w_bf16 ? round_bf16(v) : v;
    }
    __syncthreads();

    // h1 = rw(e) . W1, hw = rw(e) . W2 (f32 masks: no rounding)
    for (int o = tid; o < nr * q; o += kF32Threads) {
      const int r = o / q;
      const int j = o - r * q;
      float a1 = 0.0f, a2 = 0.0f;
      for (int kk = 0; kk < c; ++kk) {
        const float v = et_s[r * c + kk];
        a1 = fmaf(v, __ldg(w1 + kk * q + j), a1);
        a2 = fmaf(v, __ldg(w2 + kk * q + j), a2);
      }
      h1[(ebase + e0 + r) * q + j] = a1;
      hw_s[o] = a2;
    }
    __syncthreads();

    // s += M^T . hw over this tile's rows
    for (int o = tid; o < p * q; o += kF32Threads) {
      const int kk = o / q;
      const int j = o - kk * q;
      float acc = s_acc[o];
      for (int r = 0; r < nr; ++r) {
        acc = fmaf(mt[r * p + kk], hw_s[r * q + j], acc);
      }
      s_acc[o] = acc;
    }
    __syncthreads();
  }

  float* sblk = s_out + blk * p * (long long)q;
  for (int i = tid; i < p * q; i += kF32Threads) sblk[i] = s_acc[i];
}

int max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  return v;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace

// Kernel J on bf16 masks.  masks (bnb, et, p) and patches (bnb, p, c) bf16;
// a_edge (bnb, et, c) bf16 or f32 (a_bf16); w1, w2 (c, q) f32 holding
// values of the weights' dtype (w_bf16 = 1: bf16, and the activations are
// rounded to bf16 before the weight products, on the tensor cores);
// outputs act (bnb, et, c) bf16 or f32 (act_bf16), h1 (bnb, et, q) f32 and
// s (bnb, p, q) f32.  The tiling comes from the wrapper (fused_kernels.
// fused_tiling): nc / nq n8 tiles of C / q, mt m16 tiles of P a warp,
// rows a stage, stages, cluster CTAs, consumer and chain warps, p_cta
// columns a CTA and the dynamic shared memory.  A tiling that differs from what this
// kernel computes or does not fit the card, P not a multiple of 8, C or q
// past 64, or masks not 16-byte aligned, is refused with
// cudaErrorInvalidValue; a tensor map the driver refuses likewise.  Every
// output element is written.
extern "C" int fused_boundary(const void* masks, const void* patches,
                              const void* a_edge, const float* w1,
                              const float* w2, void* act, float* h1, float* s,
                              long long bnb, int et, int p, int c, int q,
                              int a_bf16, int w_bf16, int act_bf16, int nc,
                              int nq, int mt, int rows, int stages, int cluster,
                              int warps, int chains, int p_cta, int smem,
                              int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnb == 0 || p == 0 || c == 0 || q == 0) return cudaSuccess;
  if (c > 64 || q > 64 || p % 8 || nc != col_tiles(c) || nq != col_tiles(q) ||
      mt != fused_mt(nc, nq) || (rows != 16 && rows != 32) ||
      rows / 16 > fused_max_rt(nc) || stages < 2 ||
      (cluster != 1 && cluster != 2 && cluster != 4) || warps < 1 ||
      chains < 1 || chains > 2 || warps + chains + 1 > kMaxWarps || p_cta != round_up((p + cluster - 1) / cluster, kBoxCols) ||
      warps * mt * 16 < p_cta || bnb * ((et + rows - 1) / rows) > 0x7fffffffLL ||
      (uintptr_t)masks % 16 != 0 ||
      smem != fused_layout(nc, nq, rows, stages, cluster, warps, p_cta, w_bf16).total ||
      smem > max_smem(device)) {
    return (int)cudaErrorInvalidValue;
  }
  if (et == 0) {   // M^T . (nothing) = 0
    return (int)cudaMemsetAsync(s, 0, sizeof(float) * (size_t)(bnb * p * q), stream);
  }
  CUtensorMap map = {};
  if (!tma_ring::encode_bf16_3d(&map, masks, (unsigned long long)p,
                                (unsigned long long)et, (unsigned long long)bnb,
                                kBoxCols, rows, CU_TENSOR_MAP_L2_PROMOTION_L2_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  const int ae_elem = a_bf16 ? 2 : 4;
  const int ae_async = c % 2 == 0 && (uintptr_t)a_edge % (2 * ae_elem) == 0;
  const FusedArgs args = {bnb,   et,     p,      c,      q,        rows,
                          stages, cluster, warps, chains, p_cta, a_bf16, w_bf16,
                          act_bf16, ae_async};
#define FUSED_CASE(NC, NQ)                                                    \
  if (nc == NC && nq == NQ)                                                   \
    return (int)launch_tc<NC, NQ>(map, patches, a_edge, w1, w2, act, h1, s,   \
                                  args, smem, stream);
#define FUSED_CASES(NC) FUSED_CASE(NC, 2) FUSED_CASE(NC, 4) FUSED_CASE(NC, 8)
  FUSED_CASES(2)
  FUSED_CASES(4)
  FUSED_CASES(8)
#undef FUSED_CASES
#undef FUSED_CASE
  return (int)cudaErrorInvalidValue;
}

// Kernel J on f32 masks (patches f32): the CUDA-core form; the other
// arguments as for fused_boundary.  smem must be what this form needs
// (f32_smem_bytes) and fit the card, else cudaErrorInvalidValue.
extern "C" int fused_boundary_f32(const void* masks, const void* patches,
                                  const void* a_edge, const float* w1,
                                  const float* w2, void* act, float* h1,
                                  float* s, long long bnb, int et, int p,
                                  int c, int q, int a_bf16, int w_bf16,
                                  int act_bf16, int smem, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnb == 0) return cudaSuccess;
  if ((size_t)smem != f32_smem_bytes(p, c, q) || smem > max_smem(device) ||
      bnb > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(fused_boundary_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_boundary_f32_kernel<<<(unsigned)bnb, kF32Threads, smem, stream>>>(
      (const float*)masks, (const float*)patches, a_edge, w1, w2, act, h1, s, et,
      p, c, q, a_bf16, w_bf16, act_bf16);
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory one block may opt in to on `device`.
extern "C" int fused_max_smem(int device) { return max_smem(device); }
