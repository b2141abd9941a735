// The mask ring of kernel H alone, two ways (scripts/torch_mask_ring.py
// builds and times it): the stages of a block's masks, rows x kW bytes,
// copied into shared memory and read back as kernel H's A words, with no
// products.  A consumer warp owns rows_per_warp rows of a tile; a tile is
// `rows` mask rows of one block, walked over the row's bytes in stages.
//   cp.async ring (kTma false): every warp copies 16-byte pieces of the
//     stage (L2 only, evict-first) and consumes; commit / wait_group and
//     one __syncthreads per stage, as kernel I's ring.
//   TMA ring (kTma true): one producer warp issues a 2D bulk tensor copy
//     per consumer warp and stage into full/empty mbarriers; consumers
//     wait on "full" and arrive on "empty" (csrc/tma_ring.cuh).
// Both store the tiles in TMA's swizzled layout and read the same words.
// Each consumer thread XORs the words of rows inside the block and writes
// its sum, so that the caller can check that every byte arrived once.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../nbody_tpu_torch/csrc/tma_ring.cuh"

namespace {

using namespace tma_ring;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(
          dst),
      "l"(src), "r"(src_bytes), "l"(policy));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int kW, int kS, bool kTma>
__global__ void __launch_bounds__(448, 1)
ring_kernel(const __grid_constant__ CUtensorMap map,
            const uint8_t* __restrict__ masks, uint32_t* __restrict__ out,
            int et, int rb, int rpw, int warps, int row_tiles,
            long long ntiles, int evict_first) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw_s + 1023) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw_s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = warps * rpw;
  const int mstage = rows * kW;
  const uint32_t bar0 = base + kS * mstage;
  const int nst = (rb + kW - 1) / kW;
  uint64_t policy;
  if (evict_first) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
  } else {
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(policy));
  }
  const long long my_tiles =
      ((long long)ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long total = my_tiles * nst;
  auto tile_of = [&](long long it, long long* blk, int* row0, int* st) {
    const long long tile = blockIdx.x + (it / nst) * gridDim.x;
    *st = (int)(it % nst);
    *blk = tile / row_tiles;
    *row0 = (int)(tile - *blk * row_tiles) * rows;
  };

  // consumer: the A words of its rows in stage slot s
  uint32_t acc = 0;
  const int g = lane >> 2, t = lane & 3;
  auto consume = [&](int s, int row0) {
    const unsigned char* ms = smem + s * mstage + warp * rpw * kW;
    for (int mi = 0; mi < rpw / 16; ++mi) {
      const int r = row0 + warp * rpw + mi * 16 + g;
#pragma unroll
      for (int ch = 0; ch < kW / 16; ++ch) {
        const int o0 = (mi * 16 + g) * kW + ch * 16 + 4 * t;
        const uint32_t w0 =
            *reinterpret_cast<const uint32_t*>(ms + swizzle<kW>(o0));
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(ms + swizzle<kW>(o0 + 8 * kW));
        acc ^= (r < et ? w0 : 0u) ^ (r + 8 < et ? w1 : 0u);
      }
    }
  };

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < kS; ++s) {
        mbar_init(bar0 + 8 * s, 1);
        mbar_init(bar0 + 8 * (kS + s), warps);
      }
      mbar_fence_init();
    }
    __syncthreads();
    if (warp == warps) {
      if (lane == 0) {
        for (long long it = 0; it < total; ++it) {
          const int s = (int)(it % kS);
          mbar_wait(bar0 + 8 * (kS + s), (uint32_t)((it / kS) & 1) ^ 1u);
          long long blk;
          int row0, st;
          tile_of(it, &blk, &row0, &st);
          const int live = min(warps, (et - row0 + rpw - 1) / rpw);
          mbar_arrive_expect_tx(bar0 + 8 * s, (uint32_t)(live * rpw * kW));
          for (int w = 0; w < live; ++w) {
            tma_load_2d(base + s * mstage + w * rpw * kW, &map, st * kW,
                        (int)(blk * et) + row0 + w * rpw, bar0 + 8 * s,
                        policy);
          }
        }
      }
      return;
    }
    for (long long it = 0; it < total; ++it) {
      const int s = (int)(it % kS);
      mbar_wait(bar0 + 8 * s, (uint32_t)((it / kS) & 1));
      long long blk;
      int row0, st;
      tile_of(it, &blk, &row0, &st);
      if (row0 + warp * rpw < et) consume(s, row0);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar0 + 8 * (kS + s));
    }
  } else {
    const int nthreads = blockDim.x;
    auto load = [&](long long it) {
      long long blk;
      int row0, st;
      tile_of(it, &blk, &row0, &st);
      const uint8_t* mblk = masks + blk * et * (long long)rb;
      const uint32_t ms = base + (int)(it % kS) * mstage;
      constexpr int kCpr = kW / 16;
      for (int i = tid; i < rows * kCpr; i += nthreads) {
        const int r = i / kCpr, j = i - r * kCpr;
        const int byte = st * kW + 16 * j;
        const bool ok = row0 + r < et && byte < rb;
        const uint8_t* src = ok ? mblk + (long long)(row0 + r) * rb + byte : masks;
        cp_async16(ms + swizzle<kW>(r * kW + 16 * j), src, ok ? 16 : 0, policy);
      }
    };
    for (int k = 0; k < kS - 1; ++k) {
      if (k < total) load(k);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (long long it = 0; it < total; ++it) {
      cp_async_wait<kS - 2>();
      __syncthreads();
      if (it + kS - 1 < total) load(it + kS - 1);
      asm volatile("cp.async.commit_group;\n" ::);
      long long blk;
      int row0, st;
      tile_of(it, &blk, &row0, &st);
      if (row0 + warp * rpw < et) consume((int)(it % kS), row0);
    }
    cp_async_wait<0>();
  }
  out[(long long)blockIdx.x * blockDim.x + tid] = acc;
}

template <int kW, int kS, bool kTma>
int launch(const void* masks, uint32_t* out, long long bnb, int et, int rb,
           int rpw, int warps, int grid, int promotion, int evict_first,
           cudaStream_t stream) {
  const int rows = warps * rpw;
  const int row_tiles = (et + rows - 1) / rows;
  const long long ntiles = bnb * row_tiles;
  CUtensorMap map = {};
  if (kTma) {
    const CUtensorMapL2promotion promo =
        promotion == 256   ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
        : promotion == 128 ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B
        : promotion == 64  ? CU_TENSOR_MAP_L2_PROMOTION_L2_64B
                           : CU_TENSOR_MAP_L2_PROMOTION_NONE;
    if (!encode_bytes_2d(&map, masks, (unsigned long long)(bnb * et),
                         (unsigned long long)rb, kW, rpw, promo)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int smem = 1024 + kS * rows * kW + 16 * kS;
  auto kernel = ring_kernel<kW, kS, kTma>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long g = grid > 0 && grid < ntiles ? grid : ntiles;
  kernel<<<(unsigned)g, (warps + (kTma ? 1 : 0)) * 32, smem, stream>>>(
      map, (const uint8_t*)masks, out, et, rb, rpw, warps, row_tiles, ntiles,
      evict_first);
  return (int)cudaGetLastError();
}

}  // namespace

// masks (bnb, et, rb) bytes; out: grid x threads uint32 (grid <= 0: one
// CTA per tile).  kw and stages as the switch lists them.
extern "C" int mask_ring(const void* masks, uint32_t* out, long long bnb,
                         int et, int rb, int rpw, int warps, int kw,
                         int stages, int tma, int grid, int promotion,
                         int evict_first, cudaStream_t stream) {
#define RING(W, S)                                                             \
  if (kw == W && stages == S)                                                  \
    return tma ? launch<W, S, true>(masks, out, bnb, et, rb, rpw, warps, grid, \
                                    promotion, evict_first, stream)            \
               : launch<W, S, false>(masks, out, bnb, et, rb, rpw, warps,      \
                                     grid, promotion, evict_first, stream);
  RING(32, 3)
  RING(64, 2)
  RING(64, 3)
  RING(64, 4)
  RING(128, 3)
#undef RING
  return (int)cudaErrorInvalidValue;
}

extern "C" int sm_count(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
  return v;
}
