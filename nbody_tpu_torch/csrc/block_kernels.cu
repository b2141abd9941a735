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
// Gather design: each patch site is read by ET / P (2-4) edges of its
// block, so one CTA per (batch, block, C tile) stages the block's (P,
// C_tile) patch tile in shared memory; device memory then sees every patch
// and output element once.  C is tiled so that a tile fits the
// shared-memory budget the wrapper chooses (above 48 KB through
// cudaFuncSetAttribute).  Every access moves a vector of V channels (up to
// 16 bytes; the wrapper picks the widest V that divides C), and threads
// walk the tile row-major, so each warp's accesses to the streamed side
// are contiguous and wide: with one 2-byte element per access the first
// version of these kernels was bound by memory latency, not bandwidth.
//
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

const int kThreads = 256;

// V channels of one row, moved as one aligned access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void set_zero(float& x) { x = 0.0f; }
__device__ __forceinline__ void set_zero(bf16& x) { x = __float2bfloat16_rn(0.0f); }

template <typename T, int V, bool kRound>
__global__ void __launch_bounds__(kThreads)
select_gather_kernel(const T* __restrict__ patches,
                     const int32_t* __restrict__ pos, T* __restrict__ out,
                     int p, int et, int c, int ct) {
  typedef Vec<T, V> U;
  extern __shared__ __align__(16) unsigned char smem[];
  U* tile = reinterpret_cast<U*>(smem);
  const long long blk = blockIdx.x;            // flat (batch, block)
  const int c0 = blockIdx.y * ct;
  const int cw = min(ct, c - c0) / V;          // vectors per tile row
  const int cu = c / V;                        // vectors per row
  const U* src = reinterpret_cast<const U*>(patches + blk * p * (long long)c + c0);
#pragma unroll 4
  for (int i = threadIdx.x; i < p * cw; i += blockDim.x) {
    const int r = i / cw;
    U u = src[(long long)r * cu + (i - r * cw)];
    if constexpr (kRound) {
#pragma unroll
      for (int k = 0; k < V; ++k) u.v[k] = round_bf16(u.v[k]);
    }
    tile[i] = u;
  }
  __syncthreads();
  U zero;
#pragma unroll
  for (int k = 0; k < V; ++k) set_zero(zero.v[k]);
  const int32_t* pp = pos + blk * et;
  U* dst = reinterpret_cast<U*>(out + blk * et * (long long)c + c0);
#pragma unroll 4
  for (int i = threadIdx.x; i < et * cw; i += blockDim.x) {
    const int e = i / cw;
    const int j = i - e * cw;
    const int q = __ldg(pp + e);
    dst[(long long)e * cu + j] = (q >= 0 && q < p) ? tile[q * cw + j] : zero;
  }
}

struct Shape {
  long long bnb;   // batch * blocks
  int p, et, c;    // patch sites, edges per block, channels
  int ct;          // channels per CTA (a multiple of the vector width)
};

template <typename T, int V, bool kRound>
cudaError_t launch_gather(const void* patches, const int32_t* pos, void* out,
                          const Shape& s, cudaStream_t stream) {
  if (s.bnb == 0 || s.et == 0 || s.c == 0) return cudaSuccess;
  const size_t smem = (size_t)s.p * s.ct * sizeof(T);
  auto kernel = select_gather_kernel<T, V, kRound>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)s.bnb, (unsigned)((s.c + s.ct - 1) / s.ct));
  kernel<<<grid, kThreads, smem, stream>>>((const T*)patches, pos, (T*)out,
                                           s.p, s.et, s.c, s.ct);
  return cudaGetLastError();
}

// the vector widths: 1, 2, 4 (f32 and bf16) and 8 (bf16), 16 bytes at most
template <typename T, bool kRound>
cudaError_t gather_vec(int vec, const void* patches, const int32_t* pos,
                       void* out, const Shape& s, cudaStream_t stream) {
  switch (vec) {
    case 1: return launch_gather<T, 1, kRound>(patches, pos, out, s, stream);
    case 2: return launch_gather<T, 2, kRound>(patches, pos, out, s, stream);
    case 4: return launch_gather<T, 4, kRound>(patches, pos, out, s, stream);
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch_gather<T, 8, kRound>(patches, pos, out, s, stream);
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// patches (bnb, p, c) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), pos (bnb, et)
// int32 -> out (bnb, et, c) in the same dtype.  ct: channels per CTA
// (shared memory p * ct * element size); vec: channels per access, dividing
// c and ct (the buffers aligned to vec elements).  round_bf16 rounds f32
// input to bf16 first.  Returns cudaGetLastError() after the launch.
extern "C" int block_select_gather(const void* patches, const int32_t* pos,
                                   void* out, long long bnb, int p, int et,
                                   int c, int ct, int vec, int is_bf16,
                                   int round_bf16, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{bnb, p, et, c, ct};
  if (is_bf16) {
    err = gather_vec<bf16, false>(vec, patches, pos, out, s, stream);
  } else if (round_bf16) {
    err = gather_vec<float, true>(vec, patches, pos, out, s, stream);
  } else {
    err = gather_vec<float, false>(vec, patches, pos, out, s, stream);
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

// Largest dynamic shared memory one block may opt in to on `device`.
extern "C" int block_select_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  return v;
}
