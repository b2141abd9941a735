// Kernel A: k smallest of each row -- the selection step of the lattice kNN.
//
// Replaces nbody_tpu/ops/pallas/topk_kernels.py : topk_min_pallas
// (_topk_kernel), which ran k argmin+mask passes over a VMEM-resident row
// tile.  Same result, bit for bit: for each row of d2 (rows, m) f32, the k
// slots of the smallest values in ascending order, ties to the lowest slot,
// under the clamp encoding  NaN -> FLT_MAX/2,  +inf and anything larger
// than FLT_MAX/4 -> FLT_MAX/4  (topk_kernels.py:34-35), so that
// NaN > +inf > finite and k distinct slots come out even when a row holds
// fewer than k finite candidates.  That is jax.lax.top_k(-d2, k) order.
//
// What bounds it on the H100: memory.  Each row is m*4 bytes read once
// (m = 125 at window 2) and k*4 bytes written; the work per byte is a few
// compares, far under 1 FLOP/byte.  Design: a block stages a tile of rows
// in shared memory with coalesced loads (consecutive threads read
// consecutive words), then one thread per row scans its m candidates in
// ascending slot order and keeps a sorted k-list in registers.  Insertion
// is strict '<' (a new candidate goes after every kept value equal to it),
// which is exactly the lowest-slot tie rule.  With m odd the per-thread row
// stride in shared memory is odd, so the scan is free of bank conflicts.
// Fusing the candidate distances into this kernel, so that (rows, m) never
// reaches device memory, is later work.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

__device__ __forceinline__ float clamp_encode(float d) {
  return isnan(d) ? FLT_MAX * 0.5f : fminf(d, FLT_MAX * 0.25f);
}

// KMAX: compile-time bound on k so the sorted list lives in registers
// (every index below is a compile-time constant after unrolling).
template <int KMAX>
__global__ void topk_min_kernel(const float* __restrict__ d2,
                                int32_t* __restrict__ out,
                                long long rows, int m, int k) {
  extern __shared__ float tile[];               // blockDim.x rows x m
  const long long row0 = (long long)blockIdx.x * blockDim.x;
  const long long left = rows - row0;
  const int nrows = left < blockDim.x ? (int)left : (int)blockDim.x;
  const float* src = d2 + row0 * m;
  for (int i = threadIdx.x; i < nrows * m; i += blockDim.x) tile[i] = src[i];
  __syncthreads();
  if ((int)threadIdx.x >= nrows) return;

  const float* row = tile + threadIdx.x * m;
  float val[KMAX];
  int slot[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    val[t] = FLT_MAX;        // above every encoded value: always replaced
    slot[t] = -1;
  }
  for (int j = 0; j < m; ++j) {
    const float v = clamp_encode(row[j]);
    // insert v after every kept value <= v; shift the larger ones right
#pragma unroll
    for (int t = KMAX - 1; t > 0; --t) {
      if (t < k) {
        if (val[t - 1] > v) {
          val[t] = val[t - 1];
          slot[t] = slot[t - 1];
        } else if (val[t] > v) {
          val[t] = v;
          slot[t] = j;
        }
      }
    }
    if (val[0] > v) {
      val[0] = v;
      slot[0] = j;
    }
  }
  int32_t* o = out + (row0 + threadIdx.x) * k;
#pragma unroll
  for (int t = 0; t < KMAX; ++t)
    if (t < k) o[t] = slot[t];
}

}  // namespace

// Shared-memory budget of one block: the 48 KB a launch gets without an
// opt-in attribute.
static const int kSmemFloats = 48 * 1024 / 4;

extern "C" int topk_max_m() { return kSmemFloats; }

// d2 (rows, m) f32 contiguous -> out (rows, k) int32.  1 <= k <= 32,
// k <= m <= topk_max_m().  Returns cudaGetLastError() after the launch.
extern "C" int topk_min_f32(const float* d2, int32_t* out, long long rows,
                            int m, int k, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  int rpb = kSmemFloats / m;                   // rows per block
  rpb = rpb >= 128 ? 128 : (rpb >= 32 ? rpb / 32 * 32 : rpb);
  const long long blocks = (rows + rpb - 1) / rpb;
  const size_t smem = (size_t)rpb * m * sizeof(float);
  if (k <= 16) {
    topk_min_kernel<16><<<(unsigned)blocks, rpb, smem, stream>>>(
        d2, out, rows, m, k);
  } else {
    topk_min_kernel<32><<<(unsigned)blocks, rpb, smem, stream>>>(
        d2, out, rows, m, k);
  }
  return (int)cudaGetLastError();
}
