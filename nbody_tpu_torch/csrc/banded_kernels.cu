// Kernels B and C: the neighbor gather and its transpose, the scatter-add,
// computed as a segment sum over a target-sorted edge list.
//
// Kernel B replaces nbody_tpu/ops/pallas/banded_kernels.py :
// banded_gather_pallas (_gather_kernel), kernel C replaces
// banded_scatter_add_pallas (_scatter_kernel).  On the TPU both were one-hot
// matmuls built in VMEM, because XLA's dynamic gather was slow there; on the
// H100 they are what they compute:
//   gather:  out[b, n, k, :] = values[b, idx[b, n, k], :]
//   scatter: out[b, j, :]   = sum of vals[b, n, k, :] over idx[b, n, k] == j
// with the exact (band = None) semantics: the port's lattice kNN only yields
// targets inside the band the Pallas kernels covered (ops/banded.py:37-46).
// A target outside [0, N) reads 0 in the gather and is dropped by the
// scatter, as an out-of-band target was on the TPU; the kernels never touch
// memory outside their buffers.
//
// What bounds them on the H100: memory, at well under 1 FLOP/byte.  The
// gather moves B*N*K*C elements out and reads idx once; the scatter reads
// the same B*N*K*C elements, the plan's edge order and offsets, and writes
// B*N*C.  At the main path's widths (32^3 particles, batch 4, K 14, C <= 64)
// the (B, N, C) side is at most 32 MB and stays in the 50 MB L2, so device
// memory sees mostly the streamed (B, N, K, C) side.
//
// Gather design: one thread per output unit, consecutive threads on
// consecutive addresses of the streamed side, so every warp's loads and
// stores of it are coalesced.  Each row is copied in the widest unit (16,
// 8, 4 or 2 bytes) its byte length and alignment allow -- an exact bit copy
// in any dtype, with no rounding of f32 input.
//
// Scatter design (the segment sum): the caller's graph plan lists the flat
// edge ids (b*N + n)*K + k sorted by target b*N + idx, ties by ascending
// edge id (`order`), with each target's run delimited by `offsets` (B*N + 1
// entries; edges of a target outside [0, N) lie past the last offset).
// Each target row is owned by ceil(C / V) threads, one per V-element vector
// of the row (16 bytes where the row length and alignment allow: 8 lanes
// per row at C 64 bf16, 16 at C 64 f32; rows of 2 or 6 bytes at C 1 or 3
// take one 2-byte element per thread, so every thread still owns work).
// A thread walks its target's in-edges in plan order, four at a time so
// that four row loads are in flight, and accumulates in f32 registers
// (bf16 is widened exactly).  The in-degree is data-dependent (about 14
// on average, up to ~40 on displaced cubes), so the loop is bounded by the
// offsets.  The row is written once, rounded to bf16 in-kernel (round to
// nearest even, as torch's cast) where the input is bf16: no memset, no
// atomics, no cast pass.
//
// Exactness: each sum is taken in ascending edge order, the order in which
// the plain version's index_add_ on the CPU adds (sequentially over the
// index, like np.add.at), so the kernel is bit-equal to the CPU plain
// version in f32 and in bf16, and deterministic from launch to launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename U, typename I>
__global__ void gather_rows_kernel(const U* __restrict__ values,
                                   const int32_t* __restrict__ idx,
                                   U* __restrict__ out, I n, I nk, I upr,
                                   I total) {
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const I e = i / upr;                 // flat edge (b, n, k)
  const I u = i - e * upr;             // unit within the row
  const I b = e / nk;
  const int32_t j = __ldg(idx + e);
  U v{};
  if (j >= 0 && (I)j < n) v = __ldg(values + (b * n + (I)j) * upr + u);
  out[i] = v;
}

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

template <typename T, int V>
__device__ __forceinline__ void accumulate(float (&acc)[V],
                                           const Pack<T, V>& p) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] += to_f32(p.v[i]);
}

template <typename T, int V, typename I>
__global__ void segment_sum_kernel(const T* __restrict__ vals,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ offsets,
                                   T* __restrict__ out, I lanes, I c,
                                   I total) {
  using P = Pack<T, V>;
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const I row = i / lanes;             // target b*N + j
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
    accumulate(acc, p0);                 // in plan order: the sum's order
    accumulate(acc, p1);
    accumulate(acc, p2);
    accumulate(acc, p3);
  }
  for (; e < end; ++e)
    accumulate(acc, *reinterpret_cast<const P*>(
                        src + (I)__ldg(order + e) * c));
  P o;
#pragma unroll
  for (int t = 0; t < V; ++t) from_f32(acc[t], &o.v[t]);
  *reinterpret_cast<P*>(out + row * c + lane * V) = o;
}

const int kThreads = 256;

template <typename U>
cudaError_t launch_gather(const void* values, const int32_t* idx, void* out,
                          long long b, long long n, long long k,
                          long long row_bytes, cudaStream_t stream) {
  const long long upr = row_bytes / (long long)sizeof(U);
  const long long total = b * n * k * upr;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (b * n * upr < (1LL << 31) && total < (1LL << 31)) {
    gather_rows_kernel<U, uint32_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const U*)values, idx, (U*)out, (uint32_t)n, (uint32_t)(n * k),
        (uint32_t)upr, (uint32_t)total);
  } else {
    gather_rows_kernel<U, uint64_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const U*)values, idx, (U*)out, (uint64_t)n, (uint64_t)(n * k),
        (uint64_t)upr, (uint64_t)total);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_segment_sum(const void* vals, const int32_t* order,
                               const int32_t* offsets, void* out,
                               long long rows, long long edges, long long c,
                               cudaStream_t stream) {
  const long long lanes = c / V;
  const long long total = rows * lanes;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (edges * c < (1LL << 31) && rows * c < (1LL << 31)) {
    segment_sum_kernel<T, V, uint32_t><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
        (const T*)vals, order, offsets, (T*)out, (uint32_t)lanes,
        (uint32_t)c, (uint32_t)total);
  } else {
    segment_sum_kernel<T, V, uint64_t><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
        (const T*)vals, order, offsets, (T*)out, (uint64_t)lanes,
        (uint64_t)c, (uint64_t)total);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_segment_sum(int v, const void* vals,
                                 const int32_t* order, const int32_t* offsets,
                                 void* out, long long rows, long long edges,
                                 long long c, cudaStream_t stream) {
  switch (v) {
    case 1: return launch_segment_sum<T, 1>(vals, order, offsets, out, rows, edges, c, stream);
    case 2: return launch_segment_sum<T, 2>(vals, order, offsets, out, rows, edges, c, stream);
    case 4: return launch_segment_sum<T, 4>(vals, order, offsets, out, rows, edges, c, stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_segment_sum<T, 8>(vals, order, offsets, out, rows, edges, c, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// values (b, n, row_bytes) bytes, idx (b, n, k) int32 -> out (b, n, k,
// row_bytes).  unit_bytes in {2, 4, 8, 16} divides row_bytes and the
// alignment of both buffers.  Returns cudaGetLastError() after the launch.
extern "C" int neighbor_gather_rows(const void* values, const int32_t* idx,
                                    void* out, long long b, long long n,
                                    long long k, long long row_bytes,
                                    int unit_bytes, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (unit_bytes) {
    case 16: err = launch_gather<uint4>(values, idx, out, b, n, k, row_bytes, stream); break;
    case 8: err = launch_gather<uint2>(values, idx, out, b, n, k, row_bytes, stream); break;
    case 4: err = launch_gather<uint32_t>(values, idx, out, b, n, k, row_bytes, stream); break;
    case 2: err = launch_gather<uint16_t>(values, idx, out, b, n, k, row_bytes, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// vals (edges, c) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1) with edges =
// b*n*k; order (edges,) int32 edge ids sorted by target; offsets (rows + 1,)
// int32 with rows = b*n -> out (rows, c) in the input dtype, every row
// written.  vec (elements per access, 1/2/4, or 8 for bf16) divides c and
// the alignment of vals and out.  Returns cudaGetLastError().
extern "C" int neighbor_segment_sum(const void* vals, const int32_t* order,
                                    const int32_t* offsets, void* out,
                                    long long rows, long long edges,
                                    long long c, int vec, int is_bf16,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = is_bf16 ? dispatch_segment_sum<uint16_t>(vec, vals, order, offsets,
                                                 out, rows, edges, c, stream)
                : dispatch_segment_sum<float>(vec, vals, order, offsets, out,
                                              rows, edges, c, stream);
  return (int)err;
}
