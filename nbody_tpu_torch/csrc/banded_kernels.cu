// Kernels B and C: the neighbor gather and its transpose, the scatter-add.
//
// Kernel B replaces nbody_tpu/ops/pallas/banded_kernels.py :
// banded_gather_pallas (_gather_kernel), kernel C replaces
// banded_scatter_add_pallas (_scatter_kernel).  On the TPU both were one-hot
// matmuls built in VMEM, because XLA's dynamic gather was slow there; on the
// H100 they are what they compute:
//   gather:  out[b, n, k, :] = values[b, idx[b, n, k], :]
//   scatter: acc[b, j, :]   += vals[b, n, k, :]   for every idx[b, n, k] == j
// with the exact (band = None) semantics: the port's lattice kNN only yields
// targets inside the band the Pallas kernels covered (ops/banded.py:37-46).
// A target outside [0, N) reads 0 in the gather and is dropped by the
// scatter, as an out-of-band target was on the TPU; the kernels never touch
// memory outside their buffers.
//
// What bounds them on the H100: memory, at well under 1 FLOP/byte.  The
// gather moves B*N*K*C elements out and reads idx once; the scatter reads
// the same and does one f32 atomic add per element into a B*N*C buffer.
// At the main path's widths (32^3 particles, batch 4, K 14, C <= 64) the
// source rows and the accumulator are at most 32 MB and stay in the 50 MB
// L2, so device memory sees mostly the streamed (B, N, K, C) side.
// Design: one thread per output unit, consecutive threads on consecutive
// addresses of the streamed side, so every warp's loads and stores of it
// are coalesced.  The gather copies each row in the widest unit (16, 8, 4
// or 2 bytes) its byte length and alignment allow -- an exact bit copy in
// any dtype, with no rounding of f32 input.  The scatter converts bf16 to
// f32 exactly and accumulates in f32, as the Pallas kernel did.
//
// Tolerance of the scatter: atomic adds land in an order that changes from
// run to run, so f32 sums differ from a sequential sum by f32 rounding of
// the reordered terms (relative error ~1e-7 of the sum of |terms| per
// target); after the cast to bf16 that is at most one bf16 ulp except where
// a sum nearly cancels.  A deterministic CSR segment-sum is later work.

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

__device__ __forceinline__ float to_f32(float x) { return x; }
// bf16 bits -> f32: exact (bf16 is the top half of an f32)
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float((unsigned)x << 16);
}

template <typename T, typename I>
__global__ void scatter_add_kernel(const T* __restrict__ vals,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ acc, I n, I nk, I c,
                                   I total) {
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const I e = i / c;
  const I ch = i - e * c;
  const I b = e / nk;
  const int32_t j = __ldg(idx + e);
  if (j < 0 || (I)j >= n) return;
  atomicAdd(acc + (b * n + (I)j) * c + ch, to_f32(vals[i]));
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

template <typename T>
cudaError_t launch_scatter(const void* vals, const int32_t* idx, float* acc,
                           long long b, long long n, long long k, long long c,
                           cudaStream_t stream) {
  const long long total = b * n * k * c;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (total < (1LL << 31)) {
    scatter_add_kernel<T, uint32_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)vals, idx, acc, (uint32_t)n, (uint32_t)(n * k),
        (uint32_t)c, (uint32_t)total);
  } else {
    scatter_add_kernel<T, uint64_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)vals, idx, acc, (uint64_t)n, (uint64_t)(n * k),
        (uint64_t)c, (uint64_t)total);
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

// vals (b, n, k, c) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), idx (b, n, k)
// int32; adds into acc (b, n, c) f32, which the caller zeroes.
extern "C" int neighbor_scatter_add_f32acc(const void* vals,
                                           const int32_t* idx, float* acc,
                                           long long b, long long n,
                                           long long k, long long c,
                                           int is_bf16, int device,
                                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = is_bf16 ? launch_scatter<uint16_t>(vals, idx, acc, b, n, k, c, stream)
                : launch_scatter<float>(vals, idx, acc, b, n, k, c, stream);
  return (int)err;
}
