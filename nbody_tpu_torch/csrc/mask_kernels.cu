// Kernels H, I and J: the integer-mask route of ops/blocked.py and the
// fused layer-boundary op.
//
// Kernel H (mask_dot_gather) replaces
//   nbody_tpu/ops/pallas/mask_kernels.py : mask_dot_gather (_gather_kernel),
// kernel I (mask_dot_scatter) replaces mask_dot_scatter (_scatter_kernel),
// kernel J (fused_boundary) replaces
//   nbody_tpu/ops/pallas/fused_kernels.py : fused_boundary_dot (_fused_kernel).
//
// H and I, for every (batch, core block) of a lattice cube, with the block's
// masks M (ET, P) stored as int8 or as packed int4 (two signed nibbles per
// byte, the even column in the low nibble):
//   H: out (ET, C) f32 = M . patches (P, C)
//   I: out (P, C)  f32 = M^T . edges (ET, C)
// They are dense products, as the Pallas kernels were: every mask entry is
// multiplied, whatever value it holds (a selection that skipped zeros would
// also change what a NaN or inf in the operand does).  The mask is widened
// to bf16 (exact for every int8 value), the operand is bf16, and the
// products accumulate in f32 on the tensor cores (nvcuda::wmma, 16x16x16
// bf16 fragments, f32 accumulators).
//
// What bounds them on the H100: at the route's shapes (ET 3328, P 1152,
// C <= 64, 512 blocks) one call streams 1.96 GB of int8 mask (0.98 GB
// packed) for 2 * ET * P * C flops per block, 128 flops per mask byte at
// C 64: under the card's ~295 flop/byte ridge, so the floor is the mask
// read (~0.6 ms int8).  The design: one CTA of 8 warps per (block, output
// row tile, 64-column tile), blocks' row tiles adjacent in the grid so
// that the operand of a block stays in L2.  The CTA walks the reduction
// axis in chunks: a 16 KB int8 (8 KB int4) mask chunk is loaded with
// 16-byte accesses, widened to bf16 in registers and stored to shared
// memory beside the chunk of the operand; the next chunk's loads are
// issued before the current chunk's products (register double buffering).
// The mask tile in shared memory is always [e][p]; I reads it col_major
// as M^T, so the transpose costs no copy.  Each CTA owns its output tile:
// no atomics, and the sums are deterministic.  Tails (ET, P or C not a
// multiple of the tile) are zero-filled in shared memory; rows whose
// bytes are not 16-byte aligned take byte loads.
//
// Kernel J, for every (batch, block) with one-hot masks M (ET, P) in bf16
// or f32 (patches cast to the masks' dtype by the wrapper, as
// boundary_reference casts them):
//   e   = relu(M . patches + a_edge)          f32
//   act = e in the patches' dtype              (ET, C)
//   h1  = rw(e) . W1                           (ET, q) f32
//   hw  = rm(rw(e) . W2)                       (ET, q)
//   s   = M^T . hw                             (P, q)  f32
// rw / rm round to the weights' / the masks' dtype (identity for f32).  J
// reads every mask tile once for both products.  It runs on the CUDA
// cores in f32 (exact products for bf16 and f32 operands alike; no TF32,
// no bf16 fragments), one CTA of 1024 threads per block walking 16-edge
// row tiles, with the block's whole s (P, q) f32 accumulator and the
// 16-row mask tile in shared memory: 188 KB at the bench shapes (P 1152,
// q 32, bf16), which is why the patches are read from L2 rather than
// staged.  One CTA per SM, each FMA of the M . patches product waiting on
// an L2 read: J is latency-bound, far from both the FMA and the memory
// roofline (PERF.md has its time against the plain version's).  No model
// path runs it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

const int kWarps = 8;
const int kThreads = kWarps * 32;
// kernel J: more warps to hide its L2 reads (1024 threads: 240 -> 102 ms
// at the bench_fused shapes against 256, measured on an H100)
const int kFusedThreads = 1024;
const int kPad = 8;        // bf16 elements of padding per shared-memory row
const int kColTile = 64;   // output columns per CTA (4 fragments)

// Tile geometry.  The mask tile is kTE x kTP entries [e][p].
template <bool kTrans>
struct Tile;
template <>
struct Tile<false> {       // H: output rows = e, reduction over p
  static const int kRF = 2;                     // 16-row fragments per warp
  static const int kRows = kWarps * 16 * kRF;   // 256 output rows per CTA
  static const int kK = 64;                     // reduction chunk
  static const int kTE = kRows, kTP = kK;
};
template <>
struct Tile<true> {        // I: output rows = p, reduction over e
  static const int kRF = 1;
  static const int kRows = kWarps * 16 * kRF;   // 128
  static const int kK = 128;
  static const int kTE = kK, kTP = kRows;
};

template <bool kTrans, int NF>
constexpr size_t dot_smem_bytes() {
  return sizeof(bf16) * (Tile<kTrans>::kTE * (Tile<kTrans>::kTP + kPad) +
                         Tile<kTrans>::kK * (NF * 16 + kPad)) +
         sizeof(float) * kWarps * 256;
}

__device__ __forceinline__ uint32_t bf16_pair(int lo, int hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// one 16-byte mask segment -> bf16 values in shared memory (16 for int8,
// 32 for int4), sign-extended
template <bool kInt4>
__device__ __forceinline__ void widen_store(const uint4& u, bf16* dst) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint4* d = reinterpret_cast<uint4*>(dst);
  if constexpr (kInt4) {
    // nibble n of a word is element n: bits [4n, 4n + 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[k] = bf16_pair((int)(w[i] << (28 - 8 * k)) >> 28,
                         (int)(w[i] << (24 - 8 * k)) >> 28);
      }
      d[i] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else {
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16_pair((int)(w[i] << 24) >> 24, (int)(w[i] << 16) >> 24);
      o[2 * i + 1] = bf16_pair((int)(w[i] << 8) >> 24, (int)w[i] >> 24);
    }
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// 16 bytes of mask row e starting at byte `byte`; zero outside the array
__device__ __forceinline__ uint4 load_mask_seg(const uint8_t* mblk,
                                               long long rb, int e, int et,
                                               long long byte, bool vec) {
  if (e >= et || byte >= rb) return make_uint4(0u, 0u, 0u, 0u);
  const uint8_t* src = mblk + (long long)e * rb + byte;
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && byte + i < rb; ++i) {
    w[i >> 2] |= (uint32_t)src[i] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 bf16 of operand row k, columns [cc, cc + 8); zero outside the array
__device__ __forceinline__ uint4 load_x_seg(const bf16* xblk, int c, int k,
                                            int kext, int cc, bool vec) {
  if (k >= kext || cc >= c) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* src = xblk + (long long)k * c + cc;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 8 && cc + i < c; ++i) {
    w[i >> 1] |= (uint32_t)s[i] << (16 * (i & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// CTAs per SM the register budget is cut for: two for I and for int4 H
// (I int8 C 64: 2.62 -> 2.24 ms, H int4 1.93 -> 1.59 ms), one for int8 H,
// which the cut to 128 registers slowed (2.01 -> 2.52 ms; H100, 32^3 b4)
template <bool kTrans, bool kInt4>
constexpr int dot_min_blocks() { return kTrans || kInt4 ? 2 : 1; }

template <bool kTrans, bool kInt4, int NF>
__global__ void __launch_bounds__(kThreads, (dot_min_blocks<kTrans, kInt4>()))
mask_dot_kernel(const uint8_t* __restrict__ masks, const bf16* __restrict__ x,
                float* __restrict__ out, int et, int p, int c, int row_tiles,
                bool vec_m, bool vec_x) {
  typedef Tile<kTrans> T;
  typedef typename std::conditional<kTrans, wmma::col_major,
                                    wmma::row_major>::type ALayout;
  constexpr int LDM = T::kTP + kPad;
  constexpr int LDX = NF * 16 + kPad;
  constexpr int kSegVals = kInt4 ? 32 : 16;             // mask values / 16 B
  constexpr int kSegsPerRow = T::kTP / kSegVals;
  constexpr int kMSegs = T::kTE * kSegsPerRow / kThreads;
  constexpr int kXRowSegs = NF * 2;
  constexpr int kXTotal = T::kK * kXRowSegs;
  constexpr int kXSegs = (kXTotal + kThreads - 1) / kThreads;
  static_assert(T::kTE * kSegsPerRow % kThreads == 0, "mask tile split");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* mt = reinterpret_cast<bf16*>(smem);                    // [kTE][LDM]
  bf16* xt = mt + T::kTE * LDM;                                // [kK][LDX]
  float* stage = reinterpret_cast<float*>(xt + T::kK * LDX);   // [warp][256]

  const long long blk = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x - blk * row_tiles) * T::kRows;
  const int c0 = blockIdx.y * kColTile;
  const int rows = kTrans ? p : et;          // output rows
  const int kext = kTrans ? et : p;          // reduction extent
  const long long rb = kInt4 ? p / 2 : p;    // mask bytes per row
  const uint8_t* mblk = masks + blk * et * rb;
  const bf16* xblk = x + blk * (long long)kext * c;
  const int nchunks = (kext + T::kK - 1) / T::kK;
  const int tid = threadIdx.x;

  uint4 mreg[kMSegs];
  uint4 xreg[kXSegs];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kMSegs; ++i) {
      const int s = tid + i * kThreads;
      const int r = s / kSegsPerRow;
      const int pv = (s - r * kSegsPerRow) * kSegVals;   // tile column
      const int e = kTrans ? k0 + r : row0 + r;
      const long long pg = kTrans ? row0 + pv : k0 + pv;
      mreg[i] = load_mask_seg(mblk, rb, e, et, kInt4 ? pg / 2 : pg, vec_m);
    }
#pragma unroll
    for (int i = 0; i < kXSegs; ++i) {
      const int s = tid + i * kThreads;
      if (s < kXTotal) {
        const int k = s / kXRowSegs;
        const int j = s - k * kXRowSegs;
        xreg[i] = load_x_seg(xblk, c, k0 + k, kext, c0 + j * 8, vec_x);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kMSegs; ++i) {
      const int s = tid + i * kThreads;
      const int r = s / kSegsPerRow;
      const int pv = (s - r * kSegsPerRow) * kSegVals;
      widen_store<kInt4>(mreg[i], mt + r * LDM + pv);
    }
#pragma unroll
    for (int i = 0; i < kXSegs; ++i) {
      const int s = tid + i * kThreads;
      if (s < kXTotal) {
        const int k = s / kXRowSegs;
        const int j = s - k * kXRowSegs;
        *reinterpret_cast<uint4*>(xt + k * LDX + j * 8) = xreg[i];
      }
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kRF][NF];
#pragma unroll
  for (int rf = 0; rf < T::kRF; ++rf) {
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) wmma::fill_fragment(acc[rf][nf], 0.0f);
  }

  load(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    store();
    __syncthreads();
    if (ch + 1 < nchunks) load((ch + 1) * T::kK);
#pragma unroll
    for (int kk = 0; kk < T::kK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[NF];
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        wmma::load_matrix_sync(b[nf], xt + kk * 16 * LDX + nf * 16, LDX);
      }
#pragma unroll
      for (int rf = 0; rf < T::kRF; ++rf) {
        const int r = (warp * T::kRF + rf) * 16;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
        if constexpr (kTrans) {
          wmma::load_matrix_sync(a, mt + kk * 16 * LDM + r, LDM);
        } else {
          wmma::load_matrix_sync(a, mt + r * LDM + kk * 16, LDM);
        }
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          wmma::mma_sync(acc[rf][nf], a, b[nf], acc[rf][nf]);
        }
      }
    }
    __syncthreads();
  }

  float* st = stage + warp * 256;
  float* oblk = out + blk * rows * (long long)c;
#pragma unroll
  for (int rf = 0; rf < T::kRF; ++rf) {
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      wmma::store_matrix_sync(st, acc[rf][nf], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = row0 + (warp * T::kRF + rf) * 16;
      const int cc0 = c0 + nf * 16;
      for (int i = lane; i < 256; i += 32) {
        const int r = r0 + (i >> 4);
        const int cc = cc0 + (i & 15);
        if (r < rows && cc < c) oblk[(long long)r * c + cc] = st[i];
      }
      __syncwarp();
    }
  }
}

template <bool kTrans, bool kInt4, int NF>
cudaError_t launch_dot(const uint8_t* masks, const bf16* x, float* out,
                       long long bnb, int et, int p, int c,
                       cudaStream_t stream) {
  typedef Tile<kTrans> T;
  const int rows = kTrans ? p : et;
  const int row_tiles = (rows + T::kRows - 1) / T::kRows;
  const size_t smem = dot_smem_bytes<kTrans, NF>();
  auto kernel = mask_dot_kernel<kTrans, kInt4, NF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rb = kInt4 ? p / 2 : p;
  const bool vec_m = rb % 16 == 0 && (uintptr_t)masks % 16 == 0;
  const bool vec_x = c % 8 == 0 && (uintptr_t)x % 16 == 0;
  const dim3 grid((unsigned)(bnb * row_tiles),
                  (unsigned)((c + kColTile - 1) / kColTile));
  kernel<<<grid, kThreads, smem, stream>>>(masks, x, out, et, p, c, row_tiles,
                                           vec_m, vec_x);
  return cudaGetLastError();
}

template <bool kTrans, bool kInt4>
cudaError_t dot_nf(const uint8_t* masks, const bf16* x, float* out,
                   long long bnb, int et, int p, int c, cudaStream_t stream) {
  switch (c > kColTile ? 4 : (c + 15) / 16) {
    case 1: return launch_dot<kTrans, kInt4, 1>(masks, x, out, bnb, et, p, c, stream);
    case 2: return launch_dot<kTrans, kInt4, 2>(masks, x, out, bnb, et, p, c, stream);
    case 3: return launch_dot<kTrans, kInt4, 3>(masks, x, out, bnb, et, p, c, stream);
    default: return launch_dot<kTrans, kInt4, 4>(masks, x, out, bnb, et, p, c, stream);
  }
}

// ---------------------------------------------------------------------------
// kernel J
// ---------------------------------------------------------------------------

const int kFusedRows = 16;   // edges per row tile

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t fused_smem_bytes(int p, int c, int q,
                                                   int elem) {
  return align16(sizeof(float) * (size_t)p * q) +
         align16((size_t)elem * kFusedRows * p) +
         sizeof(float) * (size_t)kFusedRows * (c + q);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float load_any(const void* base, long long i,
                                          bool is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(base)[i])
                 : reinterpret_cast<const float*>(base)[i];
}

template <typename TM>
__global__ void __launch_bounds__(kFusedThreads)
fused_boundary_kernel(const TM* __restrict__ masks,
                      const TM* __restrict__ patches,
                      const void* __restrict__ a_edge,
                      const float* __restrict__ w1,
                      const float* __restrict__ w2, void* __restrict__ act,
                      float* __restrict__ h1, float* __restrict__ s_out,
                      int et, int p, int c, int q, bool a_bf16, bool w_bf16,
                      bool act_bf16) {
  constexpr bool kMaskBf16 = std::is_same<TM, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_acc = reinterpret_cast<float*>(smem);                       // [P][q]
  TM* mt = reinterpret_cast<TM*>(smem + align16(sizeof(float) * (size_t)p * q));
  float* et_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(mt) +
      align16(sizeof(TM) * (size_t)kFusedRows * p));                   // [R][C]
  float* hw_s = et_s + kFusedRows * c;                                 // [R][q]

  const long long blk = blockIdx.x;
  const int tid = threadIdx.x;
  const TM* mblk = masks + blk * et * (long long)p;
  const TM* pblk = patches + blk * p * (long long)c;
  const long long ebase = blk * et;               // first edge row of block
  const int row_segs = (int)(sizeof(TM) * p / 16);
  const bool vec = (sizeof(TM) * p) % 16 == 0 &&
                   (uintptr_t)masks % 16 == 0;

  for (int i = tid; i < p * q; i += kFusedThreads) s_acc[i] = 0.0f;

  for (int e0 = 0; e0 < et; e0 += kFusedRows) {
    const int nr = min(kFusedRows, et - e0);
    // the 16-row mask tile, read once for both products
    if (vec) {
      for (int i = tid; i < kFusedRows * row_segs; i += kFusedThreads) {
        const int r = i / row_segs;
        const int j = i - r * row_segs;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (r < nr) {
          u = __ldcs(reinterpret_cast<const uint4*>(mblk + (long long)(e0 + r) * p) + j);
        }
        reinterpret_cast<uint4*>(mt + (long long)r * p)[j] = u;
      }
    } else {
      for (int i = tid; i < kFusedRows * p; i += kFusedThreads) {
        const int r = i / p;
        mt[i] = r < nr ? mblk[(long long)e0 * p + i] : TM(0.0f);
      }
    }
    __syncthreads();

    // e = relu(M . patches + a): act out, rw(e) kept in shared memory
    for (int o = tid; o < nr * c; o += kFusedThreads) {
      const int r = o / c;
      const int cc = o - r * c;
      const TM* mrow = mt + r * p;
      float acc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < p; ++k) {
        acc = fmaf(to_f32(mrow[k]), to_f32(pblk[(long long)k * c + cc]), acc);
      }
      const long long g = (ebase + e0 + r) * c + cc;
      const float v = fmaxf(acc + load_any(a_edge, g, a_bf16), 0.0f);
      if (act_bf16) {
        reinterpret_cast<bf16*>(act)[g] = __float2bfloat16_rn(v);
      } else {
        reinterpret_cast<float*>(act)[g] = v;
      }
      et_s[o] = w_bf16 ? round_bf16(v) : v;
    }
    __syncthreads();

    // h1 = rw(e) . W1, hw = rm(rw(e) . W2)
    for (int o = tid; o < nr * q; o += kFusedThreads) {
      const int r = o / q;
      const int j = o - r * q;
      float a1 = 0.0f, a2 = 0.0f;
      for (int k = 0; k < c; ++k) {
        const float v = et_s[r * c + k];
        a1 = fmaf(v, __ldg(w1 + k * q + j), a1);
        a2 = fmaf(v, __ldg(w2 + k * q + j), a2);
      }
      h1[(ebase + e0 + r) * q + j] = a1;
      hw_s[o] = kMaskBf16 ? round_bf16(a2) : a2;
    }
    __syncthreads();

    // s += M^T . hw over this tile's rows
    for (int o = tid; o < p * q; o += kFusedThreads) {
      const int k = o / q;
      const int j = o - k * q;
      float acc = s_acc[o];
      for (int r = 0; r < nr; ++r) {
        acc = fmaf(to_f32(mt[r * p + k]), hw_s[r * q + j], acc);
      }
      s_acc[o] = acc;
    }
    __syncthreads();
  }

  float* sblk = s_out + blk * p * (long long)q;
  for (int i = tid; i < p * q; i += kFusedThreads) sblk[i] = s_acc[i];
}

template <typename TM>
cudaError_t launch_fused(const void* masks, const void* patches,
                         const void* a_edge, const float* w1, const float* w2,
                         void* act, float* h1, float* s, long long bnb, int et,
                         int p, int c, int q, bool a_bf16, bool w_bf16,
                         bool act_bf16, cudaStream_t stream) {
  const size_t smem = fused_smem_bytes(p, c, q, (int)sizeof(TM));
  auto kernel = fused_boundary_kernel<TM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)bnb, kFusedThreads, smem, stream>>>(
      (const TM*)masks, (const TM*)patches, a_edge, w1, w2, act, h1, s, et, p,
      c, q, a_bf16, w_bf16, act_bf16);
  return cudaGetLastError();
}

// Kernel J on the tensor cores, for bf16 masks with P, C and q multiples
// of 16 and C <= 64: the two mask products as wmma bf16 x bf16 -> f32
// (exact products, as the CUDA-core form), 32-edge row tiles, the weight
// products and the per-edge chain on the CUDA cores.  s (P, q) f32 stays
// in shared memory as accumulator tiles that each tile's M^T . hw loads,
// adds to and stores back.  M . patches splits its reduction over P
// between warps; the partial tiles are added in a fixed order, so the
// result is deterministic.
const int kFusedTcRows = 32;

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

__host__ __device__ inline size_t fused_tc_smem_bytes(int p, int c, int q) {
  return align128(sizeof(float) * (size_t)p * q) +
         align128(sizeof(bf16) * (size_t)kFusedTcRows * (p + kPad)) +
         align128(sizeof(float) * (size_t)kFusedTcRows * c) +
         sizeof(bf16) * (size_t)kFusedTcRows * (q + kPad);
}

__global__ void __launch_bounds__(kThreads)
fused_boundary_tc_kernel(const bf16* __restrict__ masks,
                         const bf16* __restrict__ patches,
                         const void* __restrict__ a_edge,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2, void* __restrict__ act,
                         float* __restrict__ h1, float* __restrict__ s_out,
                         int et, int p, int c, int q, bool a_bf16, bool w_bf16,
                         bool act_bf16) {
  constexpr int R = kFusedTcRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldp = p + kPad, ldh = q + kPad;
  float* s_acc = reinterpret_cast<float*>(smem);                       // [P][q]
  bf16* mt = reinterpret_cast<bf16*>(smem + align128(sizeof(float) * (size_t)p * q));
  float* e_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(mt) +
      align128(sizeof(bf16) * (size_t)R * ldp));                       // [R][C]
  bf16* hw_s = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(e_s) +
      align128(sizeof(float) * (size_t)R * c));                        // [R][ldh]

  const long long blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const bf16* mblk = masks + blk * et * (long long)p;
  const bf16* pblk = patches + blk * p * (long long)c;
  const long long ebase = blk * et;
  const int row_segs = p / 8;                  // 16-byte segments per row
  const int cf = c / 16, qf = q / 16;
  const int nfe = (R / 16) * cf;               // fragments of the e tile
  const int split = kWarps / nfe;              // warps per e fragment
  const int ksteps = p / 16;

  for (int i = tid; i < p * q; i += kThreads) s_acc[i] = 0.0f;

  for (int e0 = 0; e0 < et; e0 += R) {
    const int nr = min(R, et - e0);
    for (int i = tid; i < R * row_segs; i += kThreads) {
      const int r = i / row_segs;
      const int j = i - r * row_segs;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < nr) {
        u = __ldcs(reinterpret_cast<const uint4*>(mblk + (long long)(e0 + r) * p) + j);
      }
      *reinterpret_cast<uint4*>(mt + r * ldp + j * 8) = u;
    }
    __syncthreads();

    // e = M . patches: warp (f, sp) takes fragment f over a 1/split of P
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    const int f = warp % nfe, sp = warp / nfe;
    const int rf = f / cf, nf = f - rf * cf;
    if (sp < split) {
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = sp * ksteps / split; kk < (sp + 1) * ksteps / split; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, mt + rf * 16 * ldp + kk * 16, ldp);
        wmma::load_matrix_sync(b, pblk + (long long)kk * 16 * c + nf * 16, c);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    float* ef = e_s + rf * 16 * c + nf * 16;
    for (int step = 0; step < split; ++step) {
      if (sp == step) {
        if (step > 0) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> prev;
          wmma::load_matrix_sync(prev, ef, c, wmma::mem_row_major);
          for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += prev.x[i];
        }
        wmma::store_matrix_sync(ef, acc, c, wmma::mem_row_major);
      }
      __syncthreads();
    }

    // relu(e + a): act out, rw(e) kept for the weight products
    for (int o = tid; o < nr * c; o += kThreads) {
      const long long g = (ebase + e0) * c + o;
      const float v = fmaxf(e_s[o] + load_any(a_edge, g, a_bf16), 0.0f);
      if (act_bf16) {
        reinterpret_cast<bf16*>(act)[g] = __float2bfloat16_rn(v);
      } else {
        reinterpret_cast<float*>(act)[g] = v;
      }
      e_s[o] = w_bf16 ? round_bf16(v) : v;
    }
    __syncthreads();

    // h1 = rw(e) . W1, hw = bf16(rw(e) . W2); rows past ET give hw 0
    for (int o = tid; o < R * q; o += kThreads) {
      const int r = o / q;
      const int j = o - r * q;
      float a2 = 0.0f;
      if (r < nr) {
        float a1 = 0.0f;
        for (int k = 0; k < c; ++k) {
          const float v = e_s[r * c + k];
          a1 = fmaf(v, __ldg(w1 + k * q + j), a1);
          a2 = fmaf(v, __ldg(w2 + k * q + j), a2);
        }
        h1[(ebase + e0 + r) * q + j] = a1;
      }
      hw_s[r * ldh + j] = __float2bfloat16_rn(a2);
    }
    __syncthreads();

    // s += M^T . hw: the mask tile read col_major as M^T
    for (int t = warp; t < (p / 16) * qf; t += kWarps) {
      const int pr = t / qf, nq = t - pr * qf;
      float* sf = s_acc + pr * 16 * q + nq * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::load_matrix_sync(sacc, sf, q, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, mt + kk * 16 * ldp + pr * 16, ldp);
        wmma::load_matrix_sync(b, hw_s + kk * 16 * ldh + nq * 16, ldh);
        wmma::mma_sync(sacc, a, b, sacc);
      }
      wmma::store_matrix_sync(sf, sacc, q, wmma::mem_row_major);
    }
    __syncthreads();
  }

  float* sblk = s_out + blk * p * (long long)q;
  for (int i = tid; i < p * q; i += kThreads) sblk[i] = s_acc[i];
}

int max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  return v;
}

// which form of J runs: the tensor-core one for bf16 masks of a shape it
// takes and whose shared memory fits the card, else the CUDA-core one
bool fused_use_tc(int p, int c, int q, int elem, int device) {
  return elem == 2 && p % 16 == 0 && c % 16 == 0 && q % 16 == 0 &&
         c <= 64 && fused_tc_smem_bytes(p, c, q) <= (size_t)max_smem(device);
}

}  // namespace

// masks (bnb, et, p) int8 (is_int4 = 0) or (bnb, et, p / 2) packed int4
// (is_int4 = 1; p even); x bf16: (bnb, p, c) for the gather (transpose = 0,
// kernel H) -> out (bnb, et, c) f32, or (bnb, et, c) for the scatter
// (transpose = 1, kernel I) -> out (bnb, p, c) f32.  Every output element
// is written.  Returns cudaGetLastError() after the launch.
extern "C" int mask_dot(const void* masks, const void* x, float* out,
                        long long bnb, int et, int p, int c, int transpose,
                        int is_int4, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnb == 0 || c == 0 || (transpose ? p : et) == 0) return cudaSuccess;
  if (is_int4 && p % 2) return (int)cudaErrorInvalidValue;
  const uint8_t* m = (const uint8_t*)masks;
  const bf16* xv = (const bf16*)x;
  if (transpose) {
    err = is_int4 ? dot_nf<true, true>(m, xv, out, bnb, et, p, c, stream)
                  : dot_nf<true, false>(m, xv, out, bnb, et, p, c, stream);
  } else {
    err = is_int4 ? dot_nf<false, true>(m, xv, out, bnb, et, p, c, stream)
                  : dot_nf<false, false>(m, xv, out, bnb, et, p, c, stream);
  }
  return (int)err;
}

// Kernel J.  masks (bnb, et, p) and patches (bnb, p, c) in one dtype, bf16
// (mask_bf16 = 1) or f32; a_edge (bnb, et, c) bf16 or f32 (a_bf16); w1, w2
// (c, q) f32 holding values of the weights' dtype (w_bf16 = 1: bf16, and
// the activations are rounded to bf16 before the weight products); outputs
// act (bnb, et, c) bf16 or f32 (act_bf16), h1 (bnb, et, q) f32 and
// s (bnb, p, q) f32.  Shared memory: fused_boundary_smem_bytes.  bf16
// masks of a shape the tensor-core form takes, with 32-byte aligned masks
// and patches, run it; everything else runs the CUDA-core form.
extern "C" int fused_boundary(const void* masks, const void* patches,
                              const void* a_edge, const float* w1,
                              const float* w2, void* act, float* h1, float* s,
                              long long bnb, int et, int p, int c, int q,
                              int mask_bf16, int a_bf16, int w_bf16,
                              int act_bf16, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnb == 0) return cudaSuccess;
  if (mask_bf16 && fused_use_tc(p, c, q, 2, device) &&
      (uintptr_t)masks % 32 == 0 && (uintptr_t)patches % 32 == 0) {
    const size_t smem = fused_tc_smem_bytes(p, c, q);
    err = cudaFuncSetAttribute(fused_boundary_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_boundary_tc_kernel<<<(unsigned)bnb, kThreads, smem, stream>>>(
        (const bf16*)masks, (const bf16*)patches, a_edge, w1, w2, act, h1, s,
        et, p, c, q, a_bf16, w_bf16, act_bf16);
    err = cudaGetLastError();
  } else if (mask_bf16) {
    err = launch_fused<bf16>(masks, patches, a_edge, w1, w2, act, h1, s, bnb,
                             et, p, c, q, a_bf16, w_bf16, act_bf16, stream);
  } else {
    err = launch_fused<float>(masks, patches, a_edge, w1, w2, act, h1, s, bnb,
                              et, p, c, q, a_bf16, w_bf16, act_bf16, stream);
  }
  return (int)err;
}

// Dynamic shared memory the form of kernel J that runs for this shape on
// `device` needs for one block (elem: mask bytes), and whether it is the
// tensor-core form (*tc).
extern "C" int fused_boundary_smem_bytes(int p, int c, int q, int elem,
                                         int device, int* tc) {
  *tc = fused_use_tc(p, c, q, elem, device);
  const size_t n = *tc ? fused_tc_smem_bytes(p, c, q)
                       : fused_smem_bytes(p, c, q, elem);
  return n > 0x7fffffff ? 0x7fffffff : (int)n;
}

// Largest dynamic shared memory one block may opt in to on `device`.
extern "C" int mask_max_smem(int device) { return max_smem(device); }
