// Kernels D and F's ring, a variant timed against the committed gather
// (csrc/block_kernels.cu): scripts/torch_gather_variants.py builds this file
// and calls it at the paths' shapes.  No path runs it.
//
//   out[b, n, e, :] = patches[b, n, pos[b, n, e], :]   (0 outside [0, P))
//
// Persistent CTAs (CTAs per SM from the caller) walk the blocks in order,
// each block's C tiles back to back; a unit is one (block, C tile) and
// takes all of C whenever two stages of it fit.  A producer warp fills a
// ring of stages, each one unit's patch tile and its ET positions, through
// full / empty mbarriers (csrc/tma_ring.cuh), so unit n + 1's tile lands
// while unit n's edges are written:
//   - a whole-C tile is contiguous (P * C elements) and comes in one bulk
//     copy, the positions in another;
//   - a C tile comes as ceil(P / 256) boxes of a 3D tensor map (C, P,
//     blocks), rows past P and channels past C arriving as zeros;
//   - shapes whose bytes or bases are not 16-byte multiples are copied by
//     the producer warp's plain loads into the same layout.
// Eight consumer warps write a unit's output as 16-byte vectors at every
// width: a whole-C unit's output (ET * C elements) is contiguous, so a
// vector's element i is edge i / C, channel i % C, assembled from the
// staged tile (at C a multiple of the vector, one row piece).  Why the
// committed gather has no ring: csrc/block_kernels.cu and PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../nbody_tpu_torch/csrc/tma_ring.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// box (x, y, z) of a 3D tensor map into shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, int z, uint32_t bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar),
      "l"(policy)
      : "memory");
}

// `bytes` contiguous bytes of global memory into shared memory at dst,
// completing on bar (both addresses and the size multiples of 16)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// An (outer, rows, cols) array of 2- or 4-byte elements as a 3D tensor map
// with boxes of box_cols x box_rows x 1, unswizzled (a box lands as
// box_rows rows of box_cols elements); elements outside the array arrive as
// zeros.  cols * elem_bytes and the base must be multiples of 16.
inline bool encode_rows_3d(CUtensorMap* map, const void* base, int elem_bytes,
                           unsigned long long outer, unsigned long long rows,
                           unsigned long long cols, int box_cols,
                           int box_rows, CUtensorMapL2promotion promotion) {
  tma_ring::EncodeTiled encode = tma_ring::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * elem_bytes, rows * cols * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT32,
                3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// V channels of one row, moved as one aligned access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

const int kConsumerWarps = 8;
const int kGatherThreads = (kConsumerWarps + 1) * 32;
const int kMaxCtasPerSm = 4;   // torch_gather_variants.MAX_CTAS: registers cut for it
const int kSmemAlign = 128;    // a stage's base (TMA boxes need 128 bytes)
const int kMaxBoxRows = 256;   // rows of a tensor-map box at most

// how the producer fills a stage's patch tile, and how consumers store
enum Load { kBulk, kMap, kPlainLoad };
enum Store { kRows, kFlat, kScalar };

// the ring's layout, from the caller's tiling (torch_gather_variants.ring_tiling)
struct Ring {
  long long bnb;      // batch * blocks
  int p, et, c;       // patch sites, edges per block, channels
  int ct;             // channels per unit (the C tile; c when whole)
  int col_tiles;      // units per block
  int stages;
  int tile_rows;      // rows of a stage's tile (boxes * box_rows when tiled)
  int boxes, box_rows;
  int pos_off;        // byte offset of the positions in a stage
  int stage_bytes;    // a stage's bytes (a multiple of kSmemAlign)
  Load load;
  bool pos_bulk;      // positions by bulk copy, else plain loads
  Store store;
};

// One stage's patch tile (tile_rows x ct, row-major) and positions for
// unit (blk, c0), issued by the producer warp; every lane arrives on full
// once its plain stores are done, lane 0 with the bytes its copies bring.
// The patch source is this function alone.
template <typename T>
__device__ __forceinline__ void load_unit(const Ring& r, const CUtensorMap* map,
                                          const T* __restrict__ patches,
                                          const int32_t* __restrict__ pos,
                                          unsigned char* stage, uint32_t stage_s,
                                          uint32_t full, long long blk, int c0,
                                          uint64_t policy, int lane) {
  using namespace tma_ring;
  const int32_t* pblk = pos + blk * r.et;
  if (!r.pos_bulk) {
    int32_t* spos = reinterpret_cast<int32_t*>(stage + r.pos_off);
    for (int e = lane; e < r.et; e += 32) spos[e] = __ldg(pblk + e);
  }
  const T* src = patches + blk * r.p * (long long)r.c;
  if (r.load == kPlainLoad) {
    T* tile = reinterpret_cast<T*>(stage);
    const int cw = min(r.ct, r.c - c0);
    for (int i = lane; i < r.p * cw; i += 32) {
      const int row = i / cw, k = i - row * cw;
      tile[row * r.ct + k] = src[(long long)row * r.c + c0 + k];
    }
  }
  __syncwarp();
  uint32_t tx = r.pos_bulk ? (uint32_t)r.et * 4u : 0u;
  if (r.load == kBulk) tx += (uint32_t)(r.p * r.c * (int)sizeof(T));
  if (r.load == kMap) tx += (uint32_t)(r.tile_rows * r.ct * (int)sizeof(T));
  if (lane != 0 || tx == 0) {
    mbar_arrive(full);
    return;
  }
  mbar_arrive_expect_tx(full, tx);
  if (r.pos_bulk) bulk_load(stage_s + r.pos_off, pblk, (uint32_t)r.et * 4u, full);
  if (r.load == kBulk) {
    bulk_load(stage_s, src, (uint32_t)(r.p * r.c * (int)sizeof(T)), full);
  } else if (r.load == kMap) {
    const int box_bytes = r.box_rows * r.ct * (int)sizeof(T);
    for (int b = 0; b < r.boxes; ++b) {
      tma_load_3d(stage_s + b * box_bytes, map, c0, b * r.box_rows, (int)blk,
                  full, policy);
    }
  }
}

template <typename T, bool kRound>
__device__ __forceinline__ T leave_smem(T v) {
  if constexpr (kRound) return round_bf16(v);
  return v;
}

// One unit's output from its stage, by the consumer threads (ctid of
// kConsumerWarps * 32): edge e, channel c0 + k of the block reads tile row
// pos[e], column k, or 0 where pos[e] lies outside [0, P).
template <typename T, bool kRound>
__device__ __forceinline__ void store_unit(const Ring& r,
                                           const unsigned char* stage,
                                           T* __restrict__ out, long long blk,
                                           int c0, int ctid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kStride = kConsumerWarps * 32;
  typedef Vec<T, V> U;
  const T* tile = reinterpret_cast<const T*>(stage);
  const int32_t* spos = reinterpret_cast<const int32_t*>(stage + r.pos_off);
  const int cw = min(r.ct, r.c - c0);
  T* oblk = out + blk * r.et * (long long)r.c;
  T zero;
  if constexpr (sizeof(T) == 2) {
    zero = __float2bfloat16_rn(0.0f);
  } else {
    zero = 0.0f;
  }
  if (r.store == kRows) {
    // every row piece is whole vectors: one position, one 16-byte copy;
    // vector i is edge i / vpr, piece i % vpr, stepped without division
    const int vpr = cw / V;
    const int de = kStride / vpr, dk = kStride - de * vpr;
    const U* tv = reinterpret_cast<const U*>(tile);
    int e = ctid / vpr, k = ctid - e * vpr;
    while (e < r.et) {
      const int q = spos[e];
      U u;
      if ((unsigned)q < (unsigned)r.p) {
        u = tv[q * (r.ct / V) + k];
#pragma unroll
        for (int j = 0; j < V; ++j) u.v[j] = leave_smem<T, kRound>(u.v[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) u.v[j] = zero;
      }
      *reinterpret_cast<U*>(oblk + (long long)e * r.c + c0 + k * V) = u;
      e += de, k += dk;
      if (k >= vpr) k -= vpr, ++e;
    }
  } else if (r.store == kFlat) {
    // a whole-C unit's ET * C elements, contiguous: element i of the
    // unit is edge i / C, channel i % C (a vector's first element stepped
    // without division)
    U* ov = reinterpret_cast<U*>(oblk);
    const int de = kStride * V / r.c, dch = kStride * V - de * r.c;
    int e0 = ctid * V / r.c, ch0 = ctid * V - e0 * r.c;
    for (int i = ctid; i < r.et * r.c / V; i += kStride) {
      int e = e0, ch = ch0;
      int q = spos[e];
      U u;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        u.v[j] = (unsigned)q < (unsigned)r.p
                     ? leave_smem<T, kRound>(tile[q * r.c + ch])
                     : zero;
        if (++ch == r.c) {
          ch = 0;
          if (++e < r.et) q = spos[e];
        }
      }
      ov[i] = u;
      e0 += de, ch0 += dch;
      if (ch0 >= r.c) ch0 -= r.c, ++e0;
    }
  } else {
    for (int i = ctid; i < r.et * cw; i += kStride) {
      const int e = i / cw, k = i - e * cw;
      const int q = spos[e];
      oblk[(long long)e * r.c + c0 + k] =
          (unsigned)q < (unsigned)r.p ? leave_smem<T, kRound>(tile[q * r.ct + k])
                                      : zero;
    }
  }
}

// Persistent CTAs: CTA x takes blocks x, x + grid, ..., each block's C
// tiles back to back; warp kConsumerWarps produces, the others consume.
template <typename T, bool kRound>
__global__ void __launch_bounds__(kGatherThreads, kMaxCtasPerSm)
ring_gather_kernel(const __grid_constant__ CUtensorMap map,
                    const T* __restrict__ patches,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    const Ring r) {
  using namespace tma_ring;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw_s + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1);
  unsigned char* const smem = smem_raw + (base - raw_s);
  // full[s] at bar0 + 8 s: every producer lane; empty[s] at bar0 + 8
  // (stages + s): one arrival per consumer warp
  const uint32_t bar0 = base + r.stages * r.stage_bytes;
  if (tid == 0) {
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(bar0 + 8 * s, 32);
      mbar_init(bar0 + 8 * (r.stages + s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  int it = 0;   // units walked
  if (warp == kConsumerWarps) {
    uint64_t policy;
    // evict-normal, as kernel H's ring: the tensor map promotes 128-byte
    // lines into L2, and their other half must stay for the next box
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(policy));
    for (long long blk = blockIdx.x; blk < r.bnb; blk += gridDim.x) {
      for (int t = 0; t < r.col_tiles; ++t, ++it) {
        const int s = it % r.stages;
        mbar_wait(bar0 + 8 * (r.stages + s), (uint32_t)((it / r.stages) & 1) ^ 1u);
        load_unit<T>(r, &map, patches, pos, smem + s * r.stage_bytes,
                     base + s * r.stage_bytes, bar0 + 8 * s, blk, t * r.ct,
                     policy, lane);
      }
    }
    return;
  }
  for (long long blk = blockIdx.x; blk < r.bnb; blk += gridDim.x) {
    for (int t = 0; t < r.col_tiles; ++t, ++it) {
      const int s = it % r.stages;
      mbar_wait(bar0 + 8 * s, (uint32_t)((it / r.stages) & 1));
      store_unit<T, kRound>(r, smem + s * r.stage_bytes, out, blk, t * r.ct, tid);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar0 + 8 * (r.stages + s));
    }
  }
}

// The ring for a launch: the tiling checked against the shapes (a tiling
// that does not fit, or a stage past the card's opt-in shared memory, is
// refused), then the loader and store paths the shapes and bases allow.
cudaError_t make_ring(Ring& r, const void* patches, const int32_t* pos,
                      const void* out, long long bnb, int p, int et, int c,
                      int ct, int stages, int boxes, int box_rows, int smem,
                      int elem, int device) {
  const int vec = 16 / elem;
  if (ct < 1 || ct > c || stages < 1 || boxes < 1 || box_rows < 1 ||
      box_rows > kMaxBoxRows || (ct < c && (long long)boxes * box_rows < p) ||
      (long long)p * c > 0x7fffffffLL || (long long)et * c > 0x7fffffffLL ||
      bnb > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const long long rows = ct < c ? (long long)boxes * box_rows : p;
  const long long tile_bytes = rows * ct * elem;
  const long long pos_off = (tile_bytes + 15) / 16 * 16;
  const long long stage = (pos_off + 4LL * et + kSmemAlign - 1) / kSmemAlign * kSmemAlign;
  if ((long long)smem != kSmemAlign + stages * stage + 16LL * stages) {
    return cudaErrorInvalidValue;
  }
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;
  r.bnb = bnb;
  r.p = p, r.et = et, r.c = c, r.ct = ct;
  r.col_tiles = (c + ct - 1) / ct;
  r.stages = stages;
  r.tile_rows = (int)rows;
  r.boxes = boxes, r.box_rows = box_rows;
  r.pos_off = (int)pos_off;
  r.stage_bytes = (int)stage;
  // a box lands at a 128-byte boundary, at most 256 elements wide
  const bool aligned = (uintptr_t)patches % 16 == 0;
  r.load = ct == c && aligned && p > 0 && (long long)p * c % vec == 0 ? kBulk
           : ct < c && aligned && c % vec == 0 && ct % vec == 0 &&
                   ct <= kMaxBoxRows && box_rows * ct * elem % kSmemAlign == 0
               ? kMap
               : kPlainLoad;
  r.pos_bulk = (uintptr_t)pos % 16 == 0 && et % 4 == 0;
  const bool out_aligned = (uintptr_t)out % 16 == 0;
  r.store = out_aligned && c % vec == 0 && ct % vec == 0 ? kRows
            : out_aligned && ct == c && (long long)et * c % vec == 0 ? kFlat
                                                                      : kScalar;
  return cudaSuccess;
}

template <typename T, bool kRound>
cudaError_t launch_gather(const Ring& r, const void* patches,
                          const int32_t* pos, void* out, int ctas, int smem,
                          int device, cudaStream_t stream) {
  CUtensorMap map = {};
  if (r.load == kMap &&
      !encode_rows_3d(&map, patches, (int)sizeof(T),
                                (unsigned long long)r.bnb, (unsigned long long)r.p,
                                (unsigned long long)r.c, r.ct, r.box_rows,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = ring_gather_kernel<T, kRound>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)sms * ctas;
  kernel<<<(unsigned)(r.bnb < grid ? r.bnb : grid), kGatherThreads, smem,
           stream>>>(map, (const T*)patches, pos, (T*)out, r);
  return cudaGetLastError();
}

}  // namespace

// patches (bnb, p, c) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), pos (bnb,
// et) int32 -> out (bnb, et, c) in the same dtype; a position outside [0,
// p) reads 0.  round_bf16 rounds f32 input to bf16 as it leaves shared
// memory.  The tiling comes from the caller (torch_gather_variants.
// ring_tiling): ct channels per unit, the ring's stages,
// CTAs per SM, the tensor-map boxes of a C-tiled unit (boxes x box_rows >=
// p rows) and the dynamic shared memory; one that does not fit the shapes
// or the card, or a tensor map the encoder refuses, is refused with
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
extern "C" int ring_gather(const void* patches, const int32_t* pos,
                                   void* out, long long bnb, int p, int et,
                                   int c, int ct, int stages, int ctas,
                                   int boxes, int box_rows, int smem,
                                   int is_bf16, int round_bf16, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnb == 0 || et == 0 || c == 0) return cudaSuccess;
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  Ring r;
  err = make_ring(r, patches, pos, out, bnb, p, et, c, ct, stages, boxes,
                  box_rows, smem, is_bf16 ? 2 : 4, device);
  if (err != cudaSuccess) return (int)err;
  if (is_bf16) {
    err = launch_gather<bf16, false>(r, patches, pos, out, ctas, smem, device, stream);
  } else if (round_bf16) {
    err = launch_gather<float, true>(r, patches, pos, out, ctas, smem, device, stream);
  } else {
    err = launch_gather<float, false>(r, patches, pos, out, ctas, smem, device, stream);
  }
  return (int)err;
}
