// Kernels D, E, F and G: the per-block patch selection of ops/blocked.py.
//
// Kernel D (select_gather on bf16) replaces
//   nbody_tpu/ops/pallas/idx_kernels.py : idx_dot_gather (_idx_gather_kernel),
// kernel E (select_scatter, bf16 -> f32) replaces idx_dot_scatter
//   (_idx_scatter_kernel),
// kernel F (select_gather on f32 or bf16, optional bf16 rounding) replaces
//   nbody_tpu/ops/pallas/block_kernels.py : block_gather_pallas,
// kernel G (select_scatter, f32|bf16 -> f32, optional bf16 rounding)
//   replaces block_scatter_pallas.
// All four compute, for every (batch b, core block n) of a lattice cube,
//   gather:  out[b, n, e, :]  = patches[b, n, pos[b, n, e], :]
//   scatter: out[b, n, q, :]  = sum_{e: pos[b, n, e] == q} vals[b, n, e, :]
// where pos (B, NB, ET) int32 indexes the block's dilated patch of P sites.
// On the TPU these were one-hot (ET, P) x (P, C) MXU dots with the one-hot
// synthesized in VMEM; on the H100 the selection is what it is, an indexed
// load, and the transpose an indexed add.  A position outside [0, P) reads
// 0 and is dropped by the scatter, as a one-hot row without a match was.
//
// What bounds them on the H100: memory, at well under 1 FLOP/byte.
//
// Gather design: each thread writes 16-byte vectors of its block's
// contiguous (ET, C) output -- element i of a block's output is edge
// i / C, channel i % C -- and reads the patch values straight from device
// memory.  Each patch site is read by ET / P (2.3-2.9) edges of its block,
// from L2 after the first: the blocks' CTAs run close in time, so a
// block's patch (at most ~200 KB) stays in the 50 MB L2 between its reads,
// and device memory sees every patch and output element about once.  At C
// a multiple of the vector (8 bf16, 4 f32) a vector is one 16-byte load of
// a patch row piece; at C 1-9 (rows of 2-36 bytes) its elements are loaded
// one by one, each thread stepping edge and channel without division.
// Two thirds of the bytes are the output's, so what counts is stores in
// flight: up to 2,048 threads an SM, no shared memory, no barriers.
// Why no shared memory: the first version staged a (block, C tile) per CTA
// in shared memory in two phases (48 % of the bound at C 64), and a
// persistent ring of TMA-fed patch tiles (a variant since removed) reached
// 64 % at F's C 64 and under 16 % at D's C-tiled C 64, where this kernel
// reaches 88-97 % (H100 80GB HBM3 at 700 W, PERF.md): the ring's eight
// consumer warps an SM could not keep enough stores in flight, and its C
// tiles' half rows were written apart.  The ring was faster only at C 3-9,
// by 1-5 us a call.
// Shapes off every path (a base or ET * C not a multiple of 16 bytes) take
// one element per access.

// Scatter design: the segment sum of segment_sum.cuh over the step's block
// plan (ops/kernels/block_kernels.py : block_plan): the flat edge ids
// blk*ET + e (blk = b*NB + n) sorted by patch site blk*P + pos, ties by
// ascending edge id, and each site's offsets.  Each (block, site) row of
// the f32 output is owned by C / V threads that sum its edges in plan
// order in f32 registers and store the row once: no atomics, no zero-fill,
// no shared-memory accumulator, and no C tiling (a row's edges are read
// once whatever C is).  A position outside [0, P) has no site and is
// dropped, as a one-hot row without a match was.
//
// Precision: the gathers are exact copies in the input dtype (the Pallas
// kernels' f32 output of bf16 operands held bf16 values exactly, and every
// caller cast it back to the compute dtype at once).  `round_bf16` is the
// Pallas `fast` mode of F/G: f32 operands rounded to bf16 (round to nearest
// even, as jnp.astype and torch's .to(bfloat16)) before the copy or the
// add (__float2bfloat16_rn, in-kernel).  The scatters accumulate in f32 in
// ascending edge order, the order of the plain versions' index_add_ on the
// CPU: bit-equal to them, and identical from launch to launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "segment_sum.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// V channels of one row, moved as one aligned access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// kernels D and F: the patch gather
// ---------------------------------------------------------------------------

const int kGatherThreads = 256;

// a launch's accesses (block_kernels.gather_tiling): 16-byte row pieces,
// 16-byte vectors of elements, or single elements
enum Path { kRows = 0, kFlat = 1, kScalar = 2 };

// where row q of a block's patch lies: the kernel's one patch source (the
// patches tensor, P rows of C per block)
template <typename T>
__device__ __forceinline__ const T* patch_row(const T* patches, long long blk,
                                              int p, int c, int q) {
  return patches + (blk * p + q) * (long long)c;
}

// one patch element as it leaves for the output (kRound: f32 rounded to bf16)
template <typename T, bool kRound>
__device__ __forceinline__ T take(const T* p) {
  const T v = __ldg(p);
  if constexpr (kRound) return round_bf16(v);
  return v;
}

// CTA x of a block's `chunks` takes accesses x * 256 + tid, stepping by
// chunks * 256 (block_kernels.GATHER_PER_THREAD a thread, as the wrapper
// sizes chunks).
template <typename T, bool kRound>
__global__ void __launch_bounds__(kGatherThreads)
patch_gather_kernel(const T* __restrict__ patches,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    int p, int et, int c, int chunks, Path path) {
  constexpr int V = 16 / sizeof(T);
  typedef Vec<T, V> U;
  const long long blk = blockIdx.x / chunks;
  const int first = (int)(blockIdx.x - blk * chunks) * kGatherThreads + threadIdx.x;
  const int step = chunks * kGatherThreads;
  const int32_t* pp = pos + blk * et;
  T* oblk = out + blk * et * (long long)c;
  T zero;
  if constexpr (sizeof(T) == 2) {
    zero = __float2bfloat16_rn(0.0f);
  } else {
    zero = 0.0f;
  }
  if (path == kRows) {
    // C a multiple of V: vector i is a 16-byte piece of edge i*V / C's row
    U* ov = reinterpret_cast<U*>(oblk);
    for (int i = first; i < et * c / V; i += step) {
      const int e = i * V / c;
      const int q = __ldg(pp + e);
      U u;
      if ((unsigned)q < (unsigned)p) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(
            patch_row(patches, blk, p, c, q) + (i * V - e * c)));
        u = *reinterpret_cast<const U*>(&w);
        if constexpr (kRound) {
#pragma unroll
          for (int j = 0; j < V; ++j) u.v[j] = round_bf16(u.v[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) u.v[j] = zero;
      }
      ov[i] = u;
    }
  } else if (path == kFlat) {
    // C 1-9 on the paths (or patches off a 16-byte boundary): vector i
    // holds elements i*V .. i*V + V - 1, edge by edge
    U* ov = reinterpret_cast<U*>(oblk);
    for (int i = first; i < et * c / V; i += step) {
      int e = i * V / c, ch = i * V - e * c;
      int q = __ldg(pp + e);
      U u;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        u.v[j] = (unsigned)q < (unsigned)p
                     ? take<T, kRound>(patch_row(patches, blk, p, c, q) + ch)
                     : zero;
        if (++ch == c) {
          ch = 0;
          if (++e < et) q = __ldg(pp + e);
        }
      }
      ov[i] = u;
    }
  } else {
    for (int i = first; i < et * c; i += step) {
      const int e = i / c, ch = i - e * c;
      const int q = __ldg(pp + e);
      oblk[i] = (unsigned)q < (unsigned)p
                    ? take<T, kRound>(patch_row(patches, blk, p, c, q) + ch)
                    : zero;
    }
  }
}

template <typename T, bool kRound>
cudaError_t launch_gather(const void* patches, const int32_t* pos, void* out,
                          long long bnb, int p, int et, int c, int chunks,
                          Path path, cudaStream_t stream) {
  patch_gather_kernel<T, kRound><<<(unsigned)(bnb * chunks), kGatherThreads, 0,
                                   stream>>>((const T*)patches, pos, (T*)out,
                                             p, et, c, chunks, path);
  return cudaGetLastError();
}

}  // namespace

// Kernels D and F.  patches (bnb, p, c) f32 (is_bf16 = 0) or bf16 (is_bf16
// = 1), pos (bnb, et) int32 -> out (bnb, et, c) in the same dtype; a
// position outside [0, p) reads 0.  round_bf16 rounds f32 input to bf16.
// The tiling comes from the wrapper (block_kernels.gather_tiling): the
// access path (0: 16-byte row pieces, C a multiple of the vector and both
// buffers 16-byte aligned; 1: 16-byte vectors of elements, ET * C a
// multiple of the vector and the output aligned; 2: single elements) and
// the CTAs per block; one the shapes or buffers do not allow, or a grid
// past 2^31 - 1 CTAs, is refused with cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
extern "C" int block_select_gather(const void* patches, const int32_t* pos,
                                   void* out, long long bnb, int p, int et,
                                   int c, int path, int chunks, int is_bf16,
                                   int round_bf16, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnb == 0 || et == 0 || c == 0) return cudaSuccess;
  const int vec = is_bf16 ? 8 : 4;
  const bool out16 = (uintptr_t)out % 16 == 0;
  const bool ok =
      path == kRows     ? c % vec == 0 && (uintptr_t)patches % 16 == 0 && out16
      : path == kFlat   ? (long long)et * c % vec == 0 && out16
      : path == kScalar;
  if (!ok || chunks < 1 || bnb * chunks > 0x7fffffffLL ||
      (long long)p * c > 0x7fffffffLL || (long long)et * c > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const Path pa = (Path)path;
  if (is_bf16) {
    err = launch_gather<bf16, false>(patches, pos, out, bnb, p, et, c, chunks, pa, stream);
  } else if (round_bf16) {
    err = launch_gather<float, true>(patches, pos, out, bnb, p, et, c, chunks, pa, stream);
  } else {
    err = launch_gather<float, false>(patches, pos, out, bnb, p, et, c, chunks, pa, stream);
  }
  return (int)err;
}

// kernels E and G's instance of the segment sum (the tag of segment_sum.cuh)
struct block_sites;

// vals (edges, c) f32 (in_bf16 = 0) or bf16 (in_bf16 = 1) with edges =
// bnb*et; order (edges,) int32 edge ids sorted by patch site; offsets
// (rows + 1,) int32 with rows = bnb*p -> out (rows, c) f32 per-site sums,
// every row written.  vec (elements per access, 1/2/4, or 8 for bf16)
// divides c and the alignment of vals and out; round_bf16 rounds f32 input
// to bf16 before the add.  Returns cudaGetLastError() after the launch.
extern "C" int block_select_scatter(const void* vals, const int32_t* order,
                                    const int32_t* offsets, float* out,
                                    long long rows, long long edges,
                                    long long c, int vec, int in_bf16,
                                    int round_bf16, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (in_bf16) {
    err = segsum::dispatch<block_sites, uint16_t, float, false>(
        vec, vals, order, offsets, out, rows, edges, c, stream);
  } else if (round_bf16) {
    err = segsum::dispatch<block_sites, float, float, true>(
        vec, vals, order, offsets, out, rows, edges, c, stream);
  } else {
    err = segsum::dispatch<block_sites, float, float, false>(
        vec, vals, order, offsets, out, rows, edges, c, stream);
  }
  return (int)err;
}
