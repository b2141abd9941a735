// The segment sum shared by kernel C (banded_kernels.cu) and kernels E and
// G (block_kernels.cu): every output row is the sum of the input rows its
// plan lists for it, taken in plan order.
//
//   out[t, :] = sum over e in order[offsets[t] : offsets[t + 1]] of
//               vals[e, :]
//
// The caller's plan lists the flat edge ids sorted by target, ties by
// ascending edge id (`order`), with each target's run delimited by
// `offsets` (rows + 1 entries; edges of no target lie past the last
// offset).  Each target row is owned by C / V threads, one per V-element
// vector of the row (16 bytes of input where the row length and alignment
// allow: 8 lanes per row at C 64 bf16, 16 at C 64 f32; rows of 2 or 6
// bytes take one 2-byte element per thread, so every thread still owns
// work).  A thread walks its target's edges in plan order, four at a time
// so that four row loads are in flight, and accumulates in f32 registers
// (bf16 is widened exactly; kRound first rounds f32 input to bf16, round
// to nearest even, as torch's cast).  The in-degree is data-dependent, so
// the loop is bounded by the offsets.  The row is written once, in the
// output type O (f32, or bf16 rounded in-kernel as torch's cast rounds:
// nearest even, NaN 0x7FC0): no memset, no atomics, no shared memory, no
// cast pass.
//
// Exactness: each sum is taken in ascending edge order, the order in which
// the plain versions' index_add_ on the CPU adds (sequentially over the
// index, like np.add.at), so the kernel is bit-equal to them and
// deterministic from launch to launch.
//
// Tag names the caller's instance (an incomplete type each .cu file
// declares: graph_targets for C, block_sites for E and G), so that a
// profile tells C's f32 instance from E and G's by the kernel's name.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace segsum {

const int kThreads = 256;

// V elements of T loaded or stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
// bf16 bits -> f32: exact (bf16 is the top half of an f32)
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float((unsigned)x << 16);
}

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
// f32 -> bf16 bits, round to nearest even; NaN -> 0x7FC0 (torch's cast)
__device__ __forceinline__ void from_f32(float x, uint16_t* out) {
  const unsigned u = __float_as_uint(x);
  *out = (x != x) ? (uint16_t)0x7FC0
                  : (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

template <bool kRound, typename T, int V>
__device__ __forceinline__ void accumulate(float (&acc)[V],
                                           const Pack<T, V>& p) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float x = to_f32(p.v[i]);
    if constexpr (kRound) x = __bfloat162float(__float2bfloat16_rn(x));
    acc[i] += x;
  }
}

template <typename Tag, typename T, typename O, int V, bool kRound,
          typename I>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ vals,
                   const int32_t* __restrict__ order,
                   const int32_t* __restrict__ offsets, O* __restrict__ out,
                   I lanes, I c, I total) {
  using P = Pack<T, V>;
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const I row = i / lanes;             // target
  const I lane = i - row * lanes;      // vector within the row
  const int beg = __ldg(offsets + row);
  const int end = __ldg(offsets + row + 1);
  const T* src = vals + lane * V;
  float acc[V];
#pragma unroll
  for (int t = 0; t < V; ++t) acc[t] = 0.0f;
  int e = beg;
  for (; e + 4 <= end; e += 4) {
    const I e0 = (I)__ldg(order + e), e1 = (I)__ldg(order + e + 1);
    const I e2 = (I)__ldg(order + e + 2), e3 = (I)__ldg(order + e + 3);
    const P p0 = *reinterpret_cast<const P*>(src + e0 * c);
    const P p1 = *reinterpret_cast<const P*>(src + e1 * c);
    const P p2 = *reinterpret_cast<const P*>(src + e2 * c);
    const P p3 = *reinterpret_cast<const P*>(src + e3 * c);
    accumulate<kRound>(acc, p0);         // in plan order: the sum's order
    accumulate<kRound>(acc, p1);
    accumulate<kRound>(acc, p2);
    accumulate<kRound>(acc, p3);
  }
  for (; e < end; ++e)
    accumulate<kRound>(acc, *reinterpret_cast<const P*>(
                                src + (I)__ldg(order + e) * c));
  Pack<O, V> o;
#pragma unroll
  for (int t = 0; t < V; ++t) from_f32(acc[t], &o.v[t]);
  *reinterpret_cast<Pack<O, V>*>(out + row * c + lane * V) = o;
}

template <typename Tag, typename T, typename O, int V, bool kRound>
cudaError_t launch(const void* vals, const int32_t* order,
                   const int32_t* offsets, void* out, long long rows,
                   long long edges, long long c, cudaStream_t stream) {
  const long long lanes = c / V;
  const long long total = rows * lanes;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (edges * c < (1LL << 31) && rows * c < (1LL << 31)) {
    segment_sum_kernel<Tag, T, O, V, kRound, uint32_t>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            (const T*)vals, order, offsets, (O*)out, (uint32_t)lanes,
            (uint32_t)c, (uint32_t)total);
  } else {
    segment_sum_kernel<Tag, T, O, V, kRound, uint64_t>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            (const T*)vals, order, offsets, (O*)out, (uint64_t)lanes,
            (uint64_t)c, (uint64_t)total);
  }
  return cudaGetLastError();
}

// v: elements per access (1, 2, 4, or 8 for 2-byte T) dividing c and the
// alignment of vals and out
template <typename Tag, typename T, typename O, bool kRound>
cudaError_t dispatch(int v, const void* vals, const int32_t* order,
                     const int32_t* offsets, void* out, long long rows,
                     long long edges, long long c, cudaStream_t stream) {
  switch (v) {
    case 1: return launch<Tag, T, O, 1, kRound>(vals, order, offsets, out, rows, edges, c, stream);
    case 2: return launch<Tag, T, O, 2, kRound>(vals, order, offsets, out, rows, edges, c, stream);
    case 4: return launch<Tag, T, O, 4, kRound>(vals, order, offsets, out, rows, edges, c, stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<Tag, T, O, 8, kRound>(vals, order, offsets, out, rows, edges, c, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace segsum
