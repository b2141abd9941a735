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
// Scatter design: the segment sum of segment_sum.cuh over the caller's
// graph plan (the flat edge ids (b*N + n)*K + k sorted by target b*N +
// idx, ties by ascending edge id), with the input dtype as output.  Each
// sum is taken in ascending edge order, the order in which the plain
// version's index_add_ on the CPU adds, so the kernel is bit-equal to the
// CPU plain version in f32 and in bf16, and deterministic from launch to
// launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "segment_sum.cuh"

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

// kernel C's instance of the segment sum (the tag of segment_sum.cuh)
struct graph_targets;

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
  err = is_bf16 ? segsum::dispatch<graph_targets, uint16_t, uint16_t, false>(
                      vec, vals, order, offsets, out, rows, edges, c, stream)
                : segsum::dispatch<graph_targets, float, float, false>(
                      vec, vals, order, offsets, out, rows, edges, c, stream);
  return (int)err;
}
