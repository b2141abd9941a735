// The 15-op cube-form layer's edge epilogue (models/shiftinv15.py
// shift_inv_15op_layer), forward and backward, and the edge transpose's
// assembly before the product where the layer widens (q >= C).
//
// These replace no TPU kernel: on the TPU, XLA fused the layer's
// elementwise chain into its neighbours.  In eager PyTorch the chain is a
// dozen full-size passes over (b, 2, N, K, q) edge tensors: the transpose's
// select and stack, two stacks of a gathered and a broadcast row, six
// adds, the diagonal's where, the block mask and relu, and autograd's
// mirror of each.  All of it is memory-bound (a few adds per element), so
// the only gain is to read every operand once and write every result once.
//
// Forward (edge_epilogue_kernel), per edge row (b, s, n, k) of width q:
//   block A (s = 0): ((p0 + tA) + g_col) + x_row,  block B: ((p0 + tB) +
//   x_col) + g_row, then + a9 + p11 + b1 (per sample, per sample, bias) --
//   or, on the diagonal slot (s 0, k 0), + d2 + d5 + d8 (per node) + a9 +
//   a10 + p11 + p12 + b0 + b1 -- times the block mask (1 on A, mask_b on
//   B), then relu where the network's activation is relu.  The transpose
//   term tA / tB is the product mm(T(h), w1) itself (q >= C), or the select
//   rev * (1 - mb) + t[:, 1] * mb / t[:, 0] * mb over t = mm(h, w1) and its
//   reverse-edge lookup rows rev (q < C).  Each add keeps PyTorch's dtype
//   promotion: with bf16 operands and no f32 term before it (layer 0 of a
//   bf16 network, q >= C) every add rounds to bf16, round to nearest even,
//   as torch's bf16 add does; an f32 bias or the f32 select promotes the
//   rest of the chain to f32.  The output is f32: the block mask is f32.
//   Every multiply of the chain is by an exact 0 or 1, so the kernel equals
//   the chain of PyTorch passes as values, bit for bit; only a zero's sign
//   may differ (a dead row of block B is written +0, where x * 0 keeps the
//   sign of x).  mask_b holds 0 or 1 (models/shiftinv15.BlockSymGraph).
//
// Backward (edge_epilogue_bwd_kernel), from the incoming gradient G and,
// under relu, the saved output y (G where y > 0): gp = G * mask.  It
// writes the gradients of the identity product and the transpose operand
// (gp itself for q >= C; the same select's adjoint for q < C: t[:, 0] gets
// gpB * mb, t[:, 1] gpA * mb, rev gpA * (1 - mb)), of the two broadcast
// gathers (gpA, gpB), the K-sums of gpB and gpA for x_col and x_row, gpA on
// the diagonal slot for d2, d5 and d8, and per-block partial sums of gp
// (a9, p11, b1) and of the diagonal slots (a10, p12, b0).  A second pass
// (edge_sample_sums_kernel) finishes those sums per sample and over the
// batch in a fixed order: no float atomics, so two runs give the same bits.
// Sums accumulate in f32; each result is written in its operand's dtype.
//
// Assembly (edge_transpose_kernel, q >= C): T(h) (b, 2, N, K, C) f32 from
// h, the lookup rows rev = h[:, 0] at the reverse edge and mask_b -- block
// A rev * (1 - mb) + h[:, 1] * mb, block B h[:, 0] * mb -- and its
// backward (edge_transpose_bwd_kernel): dh[:, 0] = dTB * mb, dh[:, 1] =
// dTA * mb, drev = dTA * (1 - mb).
//
// What bounds them: device memory (3.35 TB/s on an H100 SXM); a few adds
// per loaded element.  Design: a group of q / V threads owns one node (b,
// n), one V-element vector of the row each (16 bytes of f32 where q and
// the buffers' alignment allow), and walks the node's 2 K rows: the
// node's x_col / x_row, diagonal and per-sample terms are loaded once and
// kept in registers across the rows, consecutive threads touch
// consecutive addresses (two 256-byte rows a warp at q 64 f32), and a dead
// row of block B (mask_b 0, ~92 % of block B on the 32^3 K 14 graph) is
// written as zeros without reading its operands -- the chain's values
// there are multiplied by 0.  The backward's node-level K-sums stay in
// registers; its per-sample sums go through shared memory per block.
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

// the operands of one forward launch, in this order: T each, but b0 and b1
// (f32 or bf16)
enum Term {
  P0,     // (b, 2, N, K, q) mm(h, w0)
  TT,     // (b, 2, N, K, q) mm(T(h), w1), or mm(h, w1) to select from
  REV,    // (b, N, K, q) lookup rows of t[:, 0] (select only)
  G_COL,  // (b, N, K, q) gathered x_col
  G_ROW,  // (b, N, K, q) gathered x_row
  X_COL,  // (b, N, q)
  X_ROW,  // (b, N, q)
  D2,     // (b, N, q) the diagonal's node terms
  D5,
  D8,
  A9,     // (b, q) the per-sample terms
  A10,
  P11,
  P12,
  B0,     // (q,) the diagonal bias
  B1,     // (q,) the global bias
  kTerms
};
struct Terms {
  const void* p[kTerms];
};

// the gradients one backward launch writes, in this order, T each
enum Grad {
  DP0,     // (b, 2, N, K, q)
  DT,      // (b, 2, N, K, q), select only (else the caller reuses DP0's)
  DREV,    // (b, N, K, q), select only
  DG_COL,  // (b, N, K, q)
  DG_ROW,  // (b, N, K, q)
  DX_COL,  // (b, N, q)
  DX_ROW,  // (b, N, q)
  DDIAG,   // (b, N, q): d2's, d5's and d8's
  kGrads
};
struct Grads {
  void* p[kGrads];
};

template <typename T, int V>
__device__ __forceinline__ void load(const void* base, long long i,
                                     float (&v)[V]) {
  const Pack<T, V> x =
      *reinterpret_cast<const Pack<T, V>*>(static_cast<const T*>(base) + i);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f32(x.v[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store(void* base, long long i,
                                      const float (&v)[V]) {
  Pack<T, V> x;
#pragma unroll
  for (int j = 0; j < V; ++j) from_f32(v[j], &x.v[j]);
  *reinterpret_cast<Pack<T, V>*>(static_cast<T*>(base) + i) = x;
}

template <typename T, int V>
__device__ __forceinline__ void store_zero(void* base, long long i) {
  Pack<T, V> x;
#pragma unroll
  for (int j = 0; j < V; ++j) x.v[j] = T(0);
  *reinterpret_cast<Pack<T, V>*>(static_cast<T*>(base) + i) = x;
}

template <int V>
__device__ __forceinline__ void load_bias(const void* base, int c, bool bf16,
                                          float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = bf16 ? to_f32(static_cast<const uint16_t*>(base)[c + j])
                : static_cast<const float*>(base)[c + j];
}

// f32 -> bf16 -> f32, round to nearest even (torch's cast)
__device__ __forceinline__ float round16(float x) {
  uint16_t b;
  from_f32(x, &b);
  return to_f32(b);
}

// v += x, rounded to bf16 where the sum's dtype is bf16
template <int V>
__device__ __forceinline__ void add(float (&v)[V], const float (&x)[V],
                                    bool bf16) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float s = __fadd_rn(v[j], x[j]);
    v[j] = bf16 ? round16(s) : s;
  }
}

template <int V>
__device__ __forceinline__ void scale(float (&v)[V], float m) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __fmul_rn(v[j], m);
}

template <int V>
__device__ __forceinline__ void accumulate(float (&acc)[V],
                                           const float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] += x[j];
}

// torch.relu (clamp_min 0): NaN stays NaN
template <int V>
__device__ __forceinline__ void relu(float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = v[j] < 0.0f ? 0.0f : v[j];
}

// threshold_backward(grad, y, 0): 0 where y <= 0
template <int V>
__device__ __forceinline__ void relu_grad(float (&g)[V], const float (&y)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) g[j] = y[j] <= 0.0f ? 0.0f : g[j];
}

// Where node id = b * N + n starts, at this thread's channel c: rowA, its
// first block-A element of a (b, 2, N, K, w) tensor; rowB, block B's;
// rowE, its first element of a (b, N, K, w) tensor.  A group of w / V
// threads owns a node, `per_block` nodes a block.
struct Node {
  long long b, rowA, rowB, rowE;
  __device__ Node(long long id, long long n, long long k, long long w, int c)
      : b(id / n) {
    rowA = (id + b * n) * k * w + c;
    rowB = rowA + n * k * w;
    rowE = id * k * w + c;
  }
};

template <typename T, int V, bool kSelect>
__global__ void __launch_bounds__(kThreads)
edge_epilogue_kernel(const Terms a, const float* __restrict__ mask_b,
                     float* __restrict__ out, long long nodes, long long n,
                     int k, int q, int per_block, bool bf16, bool bias_bf16,
                     bool use_relu) {
  const int units = q / V;
  const int local = threadIdx.x / units;
  const int c = (threadIdx.x - local * units) * V;
  const long long id = (long long)blockIdx.x * per_block + local;
  if (id >= nodes) return;
  const Node nd(id, n, k, q, c);
  const bool bias16 = bf16 && bias_bf16;   // the sum after an f32 bias is f32
  const float* mb = mask_b + id * k;
  float xc[V], xr[V], a9[V], p11[V], b1[V], v[V], x[V];
  load<T, V>(a.p[X_COL], id * q + c, xc);
  load<T, V>(a.p[X_ROW], id * q + c, xr);
  load<T, V>(a.p[A9], nd.b * q + c, a9);
  load<T, V>(a.p[P11], nd.b * q + c, p11);
  load_bias<V>(a.p[B1], c, bias_bf16, b1);

  // block A: ((p0 + tA) + g_col) + x_row, then the diagonal or the
  // per-sample terms
#pragma unroll 2
  for (int j = 0; j < k; ++j) {
    const long long r = nd.rowA + (long long)j * q;
    const long long e = nd.rowE + (long long)j * q;
    load<T, V>(a.p[P0], r, v);
    if (kSelect) {
      // rev * (1 - mb) + t[:, 1] * mb, mb 0 or 1; f32 (mask_b promotes)
      const float m = mb[j];
      if (m != 0.0f) {
        load<T, V>(a.p[TT], nd.rowB + (long long)j * q, x);
        scale<V>(x, m);
      } else {
        load<T, V>(a.p[REV], e, x);
      }
    } else {
      load<T, V>(a.p[TT], r, x);
    }
    add<V>(v, x, bf16);
    load<T, V>(a.p[G_COL], e, x);
    add<V>(v, x, bf16);
    add<V>(v, xr, bf16);
    if (j == 0) {
      // out[:, 0, :, 0] = o4 + d2 + d5 + d8 + a9 + a10 + p11 + p12 + b0 + b1
      load<T, V>(a.p[D2], id * q + c, x);
      add<V>(v, x, bf16);
      load<T, V>(a.p[D5], id * q + c, x);
      add<V>(v, x, bf16);
      load<T, V>(a.p[D8], id * q + c, x);
      add<V>(v, x, bf16);
      add<V>(v, a9, bf16);
      load<T, V>(a.p[A10], nd.b * q + c, x);
      add<V>(v, x, bf16);
      add<V>(v, p11, bf16);
      load<T, V>(a.p[P12], nd.b * q + c, x);
      add<V>(v, x, bf16);
      load_bias<V>(a.p[B0], c, bias_bf16, x);
      add<V>(v, x, bias16);
      add<V>(v, b1, bias16);
    } else {
      add<V>(v, a9, bf16);
      add<V>(v, p11, bf16);
      add<V>(v, b1, bias16);
    }
    if (use_relu) relu<V>(v);
    store<float, V>(out, r, v);
  }

  // block B: ((p0 + tB) + x_col) + g_row + a9 + p11 + b1, times mask_b
#pragma unroll 2
  for (int j = 0; j < k; ++j) {
    const long long r = nd.rowB + (long long)j * q;
    const float m = mb[j];
    if (m == 0.0f) {
      store_zero<float, V>(out, r);
      continue;
    }
    load<T, V>(a.p[P0], r, v);
    if (kSelect) {
      load<T, V>(a.p[TT], nd.rowA + (long long)j * q, x);   // t[:, 0] * mb
      scale<V>(x, m);
    } else {
      load<T, V>(a.p[TT], r, x);
    }
    add<V>(v, x, bf16);
    add<V>(v, xc, bf16);
    load<T, V>(a.p[G_ROW], nd.rowE + (long long)j * q, x);
    add<V>(v, x, bf16);
    add<V>(v, a9, bf16);
    add<V>(v, p11, bf16);
    add<V>(v, b1, bias16);
    scale<V>(v, m);
    if (use_relu) relu<V>(v);
    store<float, V>(out, r, v);
  }
}

// grid (nbx, b): block x walks nodes x * per_block, + nbx * per_block, ...
// of sample blockIdx.y; partials (b, nbx, 2, q): the block's sums of gp
// over every row, and of gp over the diagonal slots
template <typename T, int V, bool kSelect>
__global__ void __launch_bounds__(kThreads)
edge_epilogue_bwd_kernel(const float* __restrict__ grad,
                         const float* __restrict__ y,
                         const float* __restrict__ mask_b, const Grads d,
                         float* __restrict__ partials, long long n, int k,
                         int q, int per_block, bool use_relu) {
  const int units = q / V;
  const int local = threadIdx.x / units;
  const int c = (threadIdx.x - local * units) * V;
  const long long sample = blockIdx.y;
  float all[V], dia[V];
#pragma unroll
  for (int t = 0; t < V; ++t) all[t] = dia[t] = 0.0f;
  for (long long i = (long long)blockIdx.x * per_block + local; i < n;
       i += (long long)gridDim.x * per_block) {
    const long long id = sample * n + i;
    const Node nd(id, n, k, q, c);
    const float* mb = mask_b + id * k;
    float acc_a[V], acc_b[V], g[V], yy[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc_a[t] = acc_b[t] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < k; ++j) {                       // block A
      const long long r = nd.rowA + (long long)j * q;
      const long long e = nd.rowE + (long long)j * q;
      load<float, V>(grad, r, g);
      if (use_relu) {
        load<float, V>(y, r, yy);
        relu_grad<V>(g, yy);
      }
      store<T, V>(d.p[DP0], r, g);
      store<T, V>(d.p[DG_COL], e, g);
      if (kSelect) {
        const float m = mb[j];
        if (m != 0.0f) {                                // t[:, 1] <- gpA * mb
          float gm[V];
#pragma unroll
          for (int t = 0; t < V; ++t) gm[t] = __fmul_rn(g[t], m);
          store<T, V>(d.p[DT], nd.rowB + (long long)j * q, gm);
          store_zero<T, V>(d.p[DREV], e);
        } else {                                        // rev <- gpA
          store_zero<T, V>(d.p[DT], nd.rowB + (long long)j * q);
          store<T, V>(d.p[DREV], e, g);
        }
      }
      accumulate<V>(acc_a, g);
      if (j == 0) {
        store<T, V>(d.p[DDIAG], id * q + c, g);
        accumulate<V>(dia, g);
      }
    }
#pragma unroll 2
    for (int j = 0; j < k; ++j) {                       // block B
      const long long r = nd.rowB + (long long)j * q;
      const long long e = nd.rowE + (long long)j * q;
      const float m = mb[j];
      if (m == 0.0f) {
        store_zero<T, V>(d.p[DP0], r);
        store_zero<T, V>(d.p[DG_ROW], e);
        if (kSelect) store_zero<T, V>(d.p[DT], nd.rowA + (long long)j * q);
        continue;
      }
      load<float, V>(grad, r, g);
      if (use_relu) {
        load<float, V>(y, r, yy);
        relu_grad<V>(g, yy);
      }
      scale<V>(g, m);
      store<T, V>(d.p[DP0], r, g);
      store<T, V>(d.p[DG_ROW], e, g);
      if (kSelect) {                                    // t[:, 0] <- gpB * mb
        float gm[V];
#pragma unroll
        for (int t = 0; t < V; ++t) gm[t] = __fmul_rn(g[t], m);
        store<T, V>(d.p[DT], nd.rowA + (long long)j * q, gm);
      }
      accumulate<V>(acc_b, g);
    }
    store<T, V>(d.p[DX_COL], id * q + c, acc_b);
    store<T, V>(d.p[DX_ROW], id * q + c, acc_a);
    accumulate<V>(all, acc_a);
    accumulate<V>(all, acc_b);
  }
  // the block's sums per channel, over its nodes in a fixed order
  __shared__ float red[2][kThreads * 4];
#pragma unroll
  for (int t = 0; t < V; ++t) {
    red[0][threadIdx.x * V + t] = all[t];
    red[1][threadIdx.x * V + t] = dia[t];
  }
  __syncthreads();
  if (local == 0) {
    float* p = partials + ((sample * gridDim.x + blockIdx.x) * 2) * q + c;
    for (int w = 0; w < 2; ++w) {
      float s[V];
#pragma unroll
      for (int t = 0; t < V; ++t) s[t] = 0.0f;
      for (int l = 0; l < per_block; ++l)
#pragma unroll
        for (int t = 0; t < V; ++t) s[t] += red[w][(l * units) * V + c + t];
#pragma unroll
      for (int t = 0; t < V; ++t) p[w * q + t] = s[t];
    }
  }
}

// grid (2, b + 1): sums[w][s] = the sum over sample s's blocks (s < b), or
// over every sample's (s == b), of partials[.][.][w], in a fixed order
__global__ void __launch_bounds__(kSumThreads)
edge_sample_sums_kernel(const float* __restrict__ partials,
                        float* __restrict__ sums, int nbx, int b, int q) {
  const int w = blockIdx.x, s = blockIdx.y;
  const int groups = blockDim.x / q;
  const int grp = threadIdx.x / q, c = threadIdx.x - grp * q;
  const int lo = s == b ? 0 : s, hi = s == b ? b : s + 1;
  float acc = 0.0f;
  if (grp < groups)
    for (int bb = lo; bb < hi; ++bb)
      for (int x = grp; x < nbx; x += groups)
        acc += partials[(((long long)bb * nbx + x) * 2 + w) * q + c];
  __shared__ float red[kSumThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  if ((int)threadIdx.x < q) {
    float t = 0.0f;
    for (int g = 0; g < groups; ++g) t += red[g * q + threadIdx.x];
    sums[((long long)w * (b + 1) + s) * q + threadIdx.x] = t;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
edge_transpose_kernel(const T* __restrict__ h, const T* __restrict__ rev,
                      const float* __restrict__ mask_b,
                      float* __restrict__ out, long long nodes, long long n,
                      int k, int w, int per_block) {
  const int units = w / V;
  const int local = threadIdx.x / units;
  const int c = (threadIdx.x - local * units) * V;
  const long long id = (long long)blockIdx.x * per_block + local;
  if (id >= nodes) return;
  const Node nd(id, n, k, w, c);
  const float* mb = mask_b + id * k;
  float x[V];
#pragma unroll 2
  for (int j = 0; j < k; ++j) {
    const long long ra = nd.rowA + (long long)j * w;
    const long long rb = nd.rowB + (long long)j * w;
    const float m = mb[j];
    if (m != 0.0f) {
      load<T, V>(h, rb, x);                 // block A: h[:, 1] * mb
      scale<V>(x, m);
      store<float, V>(out, ra, x);
      load<T, V>(h, ra, x);                 // block B: h[:, 0] * mb
      scale<V>(x, m);
      store<float, V>(out, rb, x);
    } else {
      load<T, V>(rev, nd.rowE + (long long)j * w, x);   // block A: rev
      store<float, V>(out, ra, x);
      store_zero<float, V>(out, rb);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
edge_transpose_bwd_kernel(const float* __restrict__ grad,
                          const float* __restrict__ mask_b,
                          T* __restrict__ dh, T* __restrict__ drev,
                          long long nodes, long long n, int k, int w,
                          int per_block) {
  const int units = w / V;
  const int local = threadIdx.x / units;
  const int c = (threadIdx.x - local * units) * V;
  const long long id = (long long)blockIdx.x * per_block + local;
  if (id >= nodes) return;
  const Node nd(id, n, k, w, c);
  const float* mb = mask_b + id * k;
  float x[V];
#pragma unroll 2
  for (int j = 0; j < k; ++j) {
    const long long ra = nd.rowA + (long long)j * w;
    const long long rb = nd.rowB + (long long)j * w;
    const long long e = nd.rowE + (long long)j * w;
    const float m = mb[j];
    if (m != 0.0f) {
      load<float, V>(grad, ra, x);          // dh[:, 1] = dTA * mb
      scale<V>(x, m);
      store<T, V>(dh, rb, x);
      load<float, V>(grad, rb, x);          // dh[:, 0] = dTB * mb
      scale<V>(x, m);
      store<T, V>(dh, ra, x);
      store_zero<T, V>(drev, e);
    } else {
      load<float, V>(grad, ra, x);          // drev = dTA * (1 - mb)
      store<T, V>(drev, e, x);
      store_zero<T, V>(dh, ra);
      store_zero<T, V>(dh, rb);
    }
  }
}

// nodes per block of a group of w / V threads each
int nodes_per_block(long long w, int vec) {
  return (int)(kThreads / (w / vec));
}

template <typename T, int V, bool S>
cudaError_t launch_forward(const Terms& a, const float* mask_b, float* out,
                           long long b, long long n, long long k, long long q,
                           bool bf16, bool bias_bf16, bool use_relu,
                           cudaStream_t stream) {
  const int per = nodes_per_block(q, V);
  const long long nodes = b * n;
  const long long blocks = (nodes + per - 1) / per;
  edge_epilogue_kernel<T, V, S><<<(unsigned)blocks, per * (int)(q / V), 0,
                                  stream>>>(a, mask_b, out, nodes, n, (int)k,
                                            (int)q, per, bf16, bias_bf16,
                                            use_relu);
  return cudaGetLastError();
}

template <typename T, int V, bool S>
cudaError_t launch_backward(const float* grad, const float* y,
                            const float* mask_b, const Grads& d,
                            float* partials, float* sums, long long b,
                            long long n, long long k, long long q, int nbx,
                            bool use_relu, cudaStream_t stream) {
  const int per = nodes_per_block(q, V);
  edge_epilogue_bwd_kernel<T, V, S>
      <<<dim3((unsigned)nbx, (unsigned)b), per * (int)(q / V), 0, stream>>>(
          grad, y, mask_b, d, partials, n, (int)k, (int)q, per, use_relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_sample_sums_kernel<<<dim3(2, (unsigned)b + 1), kSumThreads, 0,
                            stream>>>(partials, sums, nbx, (int)b, (int)q);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_transpose(const void* h, const void* rev,
                             const float* mask_b, float* out, long long b,
                             long long n, long long k, long long w,
                             cudaStream_t stream) {
  const int per = nodes_per_block(w, V);
  const long long nodes = b * n;
  const long long blocks = (nodes + per - 1) / per;
  edge_transpose_kernel<T, V><<<(unsigned)blocks, per * (int)(w / V), 0,
                                stream>>>((const T*)h, (const T*)rev, mask_b,
                                          out, nodes, n, (int)k, (int)w, per);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_transpose_bwd(const float* grad, const float* mask_b,
                                 void* dh, void* drev, long long b,
                                 long long n, long long k, long long w,
                                 cudaStream_t stream) {
  const int per = nodes_per_block(w, V);
  const long long nodes = b * n;
  const long long blocks = (nodes + per - 1) / per;
  edge_transpose_bwd_kernel<T, V><<<(unsigned)blocks, per * (int)(w / V), 0,
                                    stream>>>(grad, mask_b, (T*)dh, (T*)drev,
                                              nodes, n, (int)k, (int)w, per);
  return cudaGetLastError();
}

// runs the expression (naming T and V) for the element type and vector width
#define BY_TYPE(is_bf16, vec, ...)                                      \
  switch ((is_bf16) ? 8 + (vec) : (vec)) {                              \
    case 4: { using T = float; constexpr int V = 4; return (int)(__VA_ARGS__); } \
    case 2: { using T = float; constexpr int V = 2; return (int)(__VA_ARGS__); } \
    case 1: { using T = float; constexpr int V = 1; return (int)(__VA_ARGS__); } \
    case 12: { using T = uint16_t; constexpr int V = 4; return (int)(__VA_ARGS__); } \
    case 10: { using T = uint16_t; constexpr int V = 2; return (int)(__VA_ARGS__); } \
    case 9: { using T = uint16_t; constexpr int V = 1; return (int)(__VA_ARGS__); } \
    default: return (int)cudaErrorInvalidValue;                         \
  }

}  // namespace

// terms: the 16 operand pointers in Term's order (rev null unless select);
// mask_b (b, N, K) f32; out (b, 2, N, K, q) f32.  The T operands are f32
// (is_bf16 0) or bf16 (1), b0 and b1 f32 or bf16 (bias_bf16); vec (1, 2,
// 4) divides q and the alignment of every buffer, and q / vec <= 256.
// round16: the chain's sums are bf16 (bf16 operands, no f32 select).
extern "C" int edge_epilogue_forward(const void* const* terms,
                                     const float* mask_b, float* out,
                                     long long b, long long n, long long k,
                                     long long q, int vec, int is_bf16,
                                     int select, int round16, int bias_bf16,
                                     int use_relu, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b * n == 0) return cudaSuccess;
  Terms a;
  for (int i = 0; i < kTerms; ++i) a.p[i] = terms[i];
  BY_TYPE(is_bf16, vec,
          select ? launch_forward<T, V, true>(a, mask_b, out, b, n, k, q,
                                              round16, bias_bf16, use_relu,
                                              stream)
                 : launch_forward<T, V, false>(a, mask_b, out, b, n, k, q,
                                               round16, bias_bf16, use_relu,
                                               stream));
}

// grad, y (b, 2, N, K, q) f32 (y read only under use_relu); grads: the 8
// output pointers in Grad's order, T each (t and rev null unless select);
// partials (b, nbx, 2, q) and sums (2, b + 1, q) f32 scratch and result:
// sums[0][s] = the sum of gp over sample s (s < b) or the batch (s = b),
// sums[1][s] the same over the diagonal slots.
extern "C" int edge_epilogue_backward(const float* grad, const float* y,
                                      const float* mask_b,
                                      void* const* grads, float* partials,
                                      float* sums, long long b, long long n,
                                      long long k, long long q, int vec,
                                      int is_bf16, int select, int use_relu,
                                      int nbx, int device,
                                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b * n == 0) return cudaSuccess;
  Grads d;
  for (int i = 0; i < kGrads; ++i) d.p[i] = grads[i];
  BY_TYPE(is_bf16, vec,
          select ? launch_backward<T, V, true>(grad, y, mask_b, d, partials,
                                               sums, b, n, k, q, nbx,
                                               use_relu, stream)
                 : launch_backward<T, V, false>(grad, y, mask_b, d, partials,
                                                sums, b, n, k, q, nbx,
                                                use_relu, stream));
}

// h (b, 2, N, K, w), rev (b, N, K, w) in T; mask_b (b, N, K) f32 -> out
// (b, 2, N, K, w) f32
extern "C" int edge_transpose_forward(const void* h, const void* rev,
                                      const float* mask_b, float* out,
                                      long long b, long long n, long long k,
                                      long long w, int vec, int is_bf16,
                                      int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b * n == 0) return cudaSuccess;
  BY_TYPE(is_bf16, vec,
          launch_transpose<T, V>(h, rev, mask_b, out, b, n, k, w, stream));
}

// grad (b, 2, N, K, w) f32 -> dh (b, 2, N, K, w) and drev (b, N, K, w) in T
extern "C" int edge_transpose_backward(const float* grad, const float* mask_b,
                                       void* dh, void* drev, long long b,
                                       long long n, long long k, long long w,
                                       int vec, int is_bf16, int device,
                                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b * n == 0) return cudaSuccess;
  BY_TYPE(is_bf16, vec,
          launch_transpose_bwd<T, V>(grad, mask_b, dh, drev, b, n, k, w,
                                     stream));
}
