// A ring of shared-memory stages filled by the Tensor Memory Accelerator:
// mbarrier and bulk-tensor-copy primitives (PTX, sm_90a) and the host
// encoders of a 2D tensor map of bytes and a 3D one of bf16.  Kernels H
// (mask_kernels.cu) and J (fused_kernels.cu) stream their masks through
// such a ring; scripts/mask_ring.cu times the ring alone.
//
// Protocol: stage s has a "full" and an "empty" mbarrier.  The producer
// waits on empty[s] with the parity of the previous round (a fresh barrier
// passes it at once), arrives on full[s] with the bytes the copies will
// deliver (expect_tx), and issues the copies, which complete the
// transaction on full[s].  Consumers wait on full[s] with the parity of
// the round, read, and arrive on empty[s].  No __syncthreads in the loop.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tma_ring {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// an arrival that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// an arrival on `bar` once every cp.async this thread issued has landed
// (counted in the barrier's initial count)
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box (x, y) of a 2D tensor map into shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, uint32_t bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar),
      "l"(policy)
      : "memory");
}

// box (x, y, z) of a 3D tensor map into shared memory at dst
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

// byte offset `off` of a tile whose rows are `span` bytes (32, 64 or 128),
// stored by TMA with the swizzle of that span: the 16-byte granule index
// XOR the row's low bits (off bits [4, 4 + log2(span / 16)) ^= bits [7, ...))
template <int kSpan>
__device__ __forceinline__ int swizzle(int off) {
  return off ^ ((off >> 3) & ((kSpan / 16 - 1) << 4));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, row_bytes) uint8 array as a 2D tensor map with boxes of
// box_rows x span bytes, swizzled by the span (32, 64 or 128); bytes and
// rows outside the array arrive as zeros.  row_bytes and the base must be
// multiples of 16.  Returns false where the encoder refuses the map.
inline bool encode_bytes_2d(CUtensorMap* map, const void* base,
                            unsigned long long rows,
                            unsigned long long row_bytes, int span,
                            int box_rows, CUtensorMapL2promotion promotion) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {row_bytes, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)span, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swz = span == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                 : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (d2, d1, d0) bf16 array as a 3D tensor map with boxes of box0 x box1
// x 1 elements, swizzled by 128 bytes (box0 * 2 must be 128); elements
// outside the array arrive as zeros.  d0 * 2 and the base must be multiples
// of 16.  Returns false where the encoder refuses the map.
inline bool encode_bf16_3d(CUtensorMap* map, const void* base,
                           unsigned long long d0, unsigned long long d1,
                           unsigned long long d2, int box0, int box1,
                           CUtensorMapL2promotion promotion) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma_ring
