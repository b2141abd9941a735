// The 4-op layer's epilogue (models/shiftinv.py, both network forms),
// forward and backward: the broadcast sum of the layer's four operator
// terms and its bias, and relu where the network's activation is relu.
//
// This replaces no TPU kernel: on the TPU, XLA fused the chain into its
// neighbours.  In eager PyTorch it is four broadcasting adds and a relu,
// each a full pass over the (b, rows, K, q) edge tensor, and autograd's
// mirror: relu's backward and three sums of the broadcast gradients.  All
// of it is memory-bound, so the only gain is to read every operand once
// and write every result once: the forward reads h1 and h2 and writes the
// output (3 edge passes for ~11), the backward reads the gradient and the
// output and writes the masked gradient (3 for ~6).
//
// Forward (epilogue4_kernel), per edge (b, r, j) of width q:
//   out = relu?((((h1 + h2) + h3[b, r]) + h4[b]) + bias)
// h1 and h2 are (b, rows, K, q) (h1 may be a view with row stride s >= q,
// the slice h12[..., :q] of the layer's joint product), h3 (b, rows, q),
// h4 (b, q), bias (q), all of one dtype T.  rows is N on the cube form
// and NB * R on the block-major form (b, NB, R, K, q): the layout changes
// nothing else.  Each add keeps PyTorch's order and dtype: in bf16 every
// sum rounds to bf16 (round to nearest even, as torch's bf16 add does),
// so the output equals the chain of PyTorch passes bit for bit; only a
// zero's sign may differ.
//
// Backward (epilogue4_bwd_kernel), from the incoming gradient G and, under
// relu, the saved output y: g = G where y > 0, else 0, written once in T
// (the gradient of h1 and of h2; without relu it is G itself and nothing
// is written); the K-sum of g, in f32 registers, written as h3's gradient
// in T; per-block partial sums of g over the block's nodes.  A second
// pass (epilogue4_sums_kernel) finishes them per sample (h4's gradient)
// and over the batch (the bias's) in a fixed order: no float atomics, so
// two runs give the same bits.
//
// What bounds them: device memory (3.35 TB/s on an H100 SXM).  Design: a
// group of q / V threads owns one node (b, r), one V-element vector of the
// row each (16 bytes where q and the buffers' alignment allow: 8 bf16 or 4
// f32), keeps the node's h3 row, h4 and bias in registers and walks the
// node's K edge rows, consecutive threads on consecutive addresses.  Rows
// of 32 bytes or less (q 16 bf16, the last layer's q 3 and 6) would leave
// a warp's accesses scattered over a dozen nodes, 2-32 bytes each: there
// the forward gives each thread one edge row (epilogue4_rows_kernel), so
// that a warp reads and writes 32 consecutive rows.  (The backward keeps
// its node groups there: a row a thread, with the K-sums through shared
// memory, measured slower on the card.)
//
// Names: none of these kernels' names contains a pattern of the
// benchmark's kernel buckets (benchmark_torch/yardstick/buckets.py), so a
// profile files them with PyTorch's own elementwise work, which they
// replace.

#include <cuda_runtime.h>

#include <cstdint>

#include "segment_sum.cuh"

namespace {

using segsum::from_f32;
using segsum::Pack;
using segsum::to_f32;

const int kThreads = 256;
const int kSumThreads = 1024;
const int kMaxVec = 8;
// the narrow path's widest row, in elements (32 bytes of bf16)
const int kNarrow = 16;

template <typename T, int V>
__device__ __forceinline__ void load(const T* base, long long i,
                                     float (&v)[V]) {
  const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(base + i);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f32(x.v[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* base, long long i,
                                      const float (&v)[V]) {
  Pack<T, V> x;
#pragma unroll
  for (int j = 0; j < V; ++j) from_f32(v[j], &x.v[j]);
  *reinterpret_cast<Pack<T, V>*>(base + i) = x;
}

// v += x in T's arithmetic: f32, or an f32 sum rounded to bf16 (exact
// operands, one rounding: torch's bf16 add)
template <typename T, int V>
__device__ __forceinline__ void add(float (&v)[V], const float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float s = __fadd_rn(v[j], x[j]);
    if constexpr (sizeof(T) == 2) {
      uint16_t r;
      from_f32(s, &r);
      v[j] = to_f32(r);
    } else {
      v[j] = s;
    }
  }
}

// a group of q / V threads a node, `per_block` nodes a block: this
// thread's node within the block and first channel
struct Lane {
  int local, c;
  __device__ Lane(int q, int vec) {
    const int units = q / vec;
    local = threadIdx.x / units;
    c = (threadIdx.x - local * units) * vec;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
epilogue4_kernel(const T* __restrict__ h1, long long s1,
                 const T* __restrict__ h2, const T* __restrict__ h3,
                 const T* __restrict__ h4, const T* __restrict__ bias,
                 T* __restrict__ out, long long nodes, long long rows, int k,
                 int q, int per_block, bool use_relu) {
  const Lane ln(q, V);
  const long long id = (long long)blockIdx.x * per_block + ln.local;
  if (id >= nodes) return;
  float x3[V], x4[V], xb[V];
  load<T, V>(h3, id * q + ln.c, x3);
  load<T, V>(h4, (id / rows) * q + ln.c, x4);
  load<T, V>(bias, ln.c, xb);
  const long long e0 = id * k;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    float v[V], x[V];
    load<T, V>(h1, (e0 + j) * s1 + ln.c, v);
    load<T, V>(h2, (e0 + j) * q + ln.c, x);
    add<T, V>(v, x);
    add<T, V>(v, x3);
    add<T, V>(v, x4);
    add<T, V>(v, xb);
    if (use_relu) {
      // torch.relu (clamp_min 0): NaN stays NaN
#pragma unroll
      for (int t = 0; t < V; ++t) v[t] = v[t] < 0.0f ? 0.0f : v[t];
    }
    store<T, V>(out, (e0 + j) * q + ln.c, v);
  }
}

// grid (nbx, b): block x walks nodes x * per_block, + nbx * per_block, ...
// of sample blockIdx.y; partials (b, nbx, q): the block's sums of g
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
epilogue4_bwd_kernel(const T* __restrict__ grad, const T* __restrict__ y,
                     T* __restrict__ dg, T* __restrict__ d3,
                     float* __restrict__ partials, long long rows, int k,
                     int q, int per_block, bool use_relu) {
  const Lane ln(q, V);
  const long long sample = blockIdx.y;
  float all[V];
#pragma unroll
  for (int t = 0; t < V; ++t) all[t] = 0.0f;
  for (long long i = (long long)blockIdx.x * per_block + ln.local; i < rows;
       i += (long long)gridDim.x * per_block) {
    const long long id = sample * rows + i;
    float acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const long long e = (id * k + j) * q + ln.c;
      float g[V];
      load<T, V>(grad, e, g);
      if (use_relu) {
        // threshold_backward(grad, y, 0): 0 where y <= 0
        float yy[V];
        load<T, V>(y, e, yy);
#pragma unroll
        for (int t = 0; t < V; ++t) g[t] = yy[t] <= 0.0f ? 0.0f : g[t];
        store<T, V>(dg, e, g);
      }
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] += g[t];
    }
    store<T, V>(d3, id * q + ln.c, acc);
#pragma unroll
    for (int t = 0; t < V; ++t) all[t] += acc[t];
  }
  // the block's sums per channel, over its nodes in a fixed order
  __shared__ float red[kThreads * kMaxVec];
#pragma unroll
  for (int t = 0; t < V; ++t) red[threadIdx.x * V + t] = all[t];
  __syncthreads();
  if (ln.local == 0) {
    const int units = q / V;
    float s[V];
#pragma unroll
    for (int t = 0; t < V; ++t) s[t] = 0.0f;
    for (int l = 0; l < per_block; ++l)
#pragma unroll
      for (int t = 0; t < V; ++t) s[t] += red[(l * units) * V + ln.c + t];
    float* p = partials + (sample * gridDim.x + blockIdx.x) * q + ln.c;
#pragma unroll
    for (int t = 0; t < V; ++t) p[t] = s[t];
  }
}

// The narrow rows' forward (q * sizeof(T) <= 32 bytes: q 16 bf16, q 3 and 6
// at the last layer): a thread owns one edge row, all of its q channels,
// so that a warp reads and writes 32 consecutive rows; h3's row comes
// through L1 for each of the node's K rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
epilogue4_rows_kernel(const T* __restrict__ h1, long long s1,
                      const T* __restrict__ h2, const T* __restrict__ h3,
                      const T* __restrict__ h4, const T* __restrict__ bias,
                      T* __restrict__ out, long long edges, long long rows,
                      int k, int q, bool use_relu) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= edges) return;
  const long long node = r / k;
  const long long b = node / rows;
#pragma unroll
  for (int p = 0; p < kNarrow / V; ++p) {
    const int c = p * V;
    if (c >= q) break;
    float v[V], x[V];
    load<T, V>(h1, r * s1 + c, v);
    load<T, V>(h2, r * q + c, x);
    add<T, V>(v, x);
    load<T, V>(h3, node * q + c, x);
    add<T, V>(v, x);
    load<T, V>(h4, b * q + c, x);
    add<T, V>(v, x);
    load<T, V>(bias, c, x);
    add<T, V>(v, x);
    if (use_relu)
#pragma unroll
      for (int t = 0; t < V; ++t) v[t] = v[t] < 0.0f ? 0.0f : v[t];
    store<T, V>(out, r * q + c, v);
  }
}

// grid (b + 1): d4[s] = the sum of sample s's partials (s < b), dbias the
// sum of every sample's (s == b), in a fixed order, written in T
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
epilogue4_sums_kernel(const float* __restrict__ partials, T* __restrict__ d4,
                      T* __restrict__ dbias, int nbx, int b, int q) {
  const int s = blockIdx.x;
  const int groups = blockDim.x / q;
  const int grp = threadIdx.x / q, c = threadIdx.x - grp * q;
  const int lo = s == b ? 0 : s, hi = s == b ? b : s + 1;
  float acc = 0.0f;
  if (grp < groups)
    for (int bb = lo; bb < hi; ++bb)
      for (int x = grp; x < nbx; x += groups)
        acc += partials[((long long)bb * nbx + x) * q + c];
  __shared__ float red[kSumThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  if ((int)threadIdx.x < q) {
    float t = 0.0f;
    for (int g = 0; g < groups; ++g) t += red[g * q + threadIdx.x];
    from_f32(t, (s == b ? dbias : d4 + (long long)s * q) + threadIdx.x);
  }
}

// nodes per block of a group of q / V threads each
int nodes_per_block(long long q, int vec) {
  return (int)(kThreads / (q / vec));
}

template <typename T, int V>
cudaError_t launch_forward(const void* h1, long long s1, const void* h2,
                           const void* h3, const void* h4, const void* bias,
                           void* out, long long b, long long rows, long long k,
                           long long q, bool narrow, bool use_relu,
                           cudaStream_t stream) {
  const long long nodes = b * rows;
  if (narrow) {
    const long long edges = nodes * k;
    epilogue4_rows_kernel<T, V>
        <<<(unsigned)((edges + kThreads - 1) / kThreads), kThreads, 0,
           stream>>>((const T*)h1, s1, (const T*)h2, (const T*)h3,
                     (const T*)h4, (const T*)bias, (T*)out, edges, rows,
                     (int)k, (int)q, use_relu);
    return cudaGetLastError();
  }
  const int per = nodes_per_block(q, V);
  const long long blocks = (nodes + per - 1) / per;
  epilogue4_kernel<T, V><<<(unsigned)blocks, per * (int)(q / V), 0, stream>>>(
      (const T*)h1, s1, (const T*)h2, (const T*)h3, (const T*)h4,
      (const T*)bias, (T*)out, nodes, rows, (int)k, (int)q, per, use_relu);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_backward(const void* grad, const void* y, void* dg,
                            void* d3, void* d4, void* dbias, float* partials,
                            long long b, long long rows, long long k,
                            long long q, int nbx, bool use_relu,
                            cudaStream_t stream) {
  const int per = nodes_per_block(q, V);
  epilogue4_bwd_kernel<T, V>
      <<<dim3((unsigned)nbx, (unsigned)b), per * (int)(q / V), 0, stream>>>(
          (const T*)grad, (const T*)y, (T*)dg, (T*)d3, partials, rows, (int)k,
          (int)q, per, use_relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  epilogue4_sums_kernel<T><<<(unsigned)b + 1, kSumThreads, 0, stream>>>(
      partials, (T*)d4, (T*)dbias, nbx, (int)b, (int)q);
  return cudaGetLastError();
}

// runs the expression (naming T and V) for the element type and vector width
#define BY_TYPE(is_bf16, vec, ...)                                      \
  switch ((is_bf16) ? 16 + (vec) : (vec)) {                             \
    case 4: { using T = float; constexpr int V = 4; return (int)(__VA_ARGS__); } \
    case 2: { using T = float; constexpr int V = 2; return (int)(__VA_ARGS__); } \
    case 1: { using T = float; constexpr int V = 1; return (int)(__VA_ARGS__); } \
    case 24: { using T = uint16_t; constexpr int V = 8; return (int)(__VA_ARGS__); } \
    case 20: { using T = uint16_t; constexpr int V = 4; return (int)(__VA_ARGS__); } \
    case 18: { using T = uint16_t; constexpr int V = 2; return (int)(__VA_ARGS__); } \
    case 17: { using T = uint16_t; constexpr int V = 1; return (int)(__VA_ARGS__); } \
    default: return (int)cudaErrorInvalidValue;                         \
  }

}  // namespace

// h1 (b, rows, K, q) with row stride s1 (q, or 2q for a slice of the
// joint product), h2 (b, rows, K, q), h3 (b, rows, q), h4 (b, q), bias (q)
// and out (b, rows, K, q), all f32 (is_bf16 0) or all bf16 (1); vec (1, 2,
// 4, and 8 for bf16) divides q, s1 and the alignment of every buffer, and
// q / vec <= 256.  narrow: a thread a row (q <= 16), else a thread group
// a node.
extern "C" int epilogue4_forward(const void* h1, long long s1, const void* h2,
                                 const void* h3, const void* h4,
                                 const void* bias, void* out, long long b,
                                 long long rows, long long k, long long q,
                                 int vec, int is_bf16, int narrow,
                                 int use_relu, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b * rows * k == 0) return cudaSuccess;
  if (narrow && q > kNarrow) return cudaErrorInvalidValue;
  BY_TYPE(is_bf16, vec,
          launch_forward<T, V>(h1, s1, h2, h3, h4, bias, out, b, rows, k, q,
                               narrow, use_relu, stream));
}

// grad and, under use_relu, y (b, rows, K, q) -> dg (b, rows, K, q; only
// under use_relu), d3 (b, rows, q), d4 (b, q) and dbias (q), all in one
// dtype as above; partials (b, nbx, q) f32 scratch, nbx blocks a sample.
extern "C" int epilogue4_backward(const void* grad, const void* y, void* dg,
                                  void* d3, void* d4, void* dbias,
                                  float* partials, long long b, long long rows,
                                  long long k, long long q, int vec,
                                  int is_bf16, int use_relu, int nbx,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b == 0) return cudaSuccess;
  BY_TYPE(is_bf16, vec,
          launch_backward<T, V>(grad, y, dg, d3, d4, dbias, partials, b, rows,
                                k, q, nbx, use_relu, stream));
}
