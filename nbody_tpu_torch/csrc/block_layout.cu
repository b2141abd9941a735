// The masked route's block layout (ops/blocked.py): block_patches, each
// core block's dilated patch gathered from the periodic cube, and
// patches_fold, its transpose, the per-block patch sums folded back into
// the cube.
//
// This replaces no Pallas kernel.  The JAX package builds the same two
// ops from XLA pads, strided slices and slice-adds
// (nbody_tpu/ops/blocked.py:122-201: the wrap pad, then ex + ey + ez
// strided slices or slice-adds, then the pad rings folded back axis by
// axis), and the eager port ran them as index_select pads, an unfold copy,
// 32 strided slice-adds into zero-filled buffers and three clone-and-add
// passes.  Both ops move bytes and do no other work (a copy; adds of 1-8
// terms a value), so they are bound by device memory (3.35 TB/s on an
// H100 SXM): each kernel reads every input value once and writes every
// output value once, with no padded cube, zero fill or scratch between.
//
// Geometry: a (cells)^3 periodic cube of N = cells^3 rows of C channels in
// z-major order (row (x * cells + y) * cells + z); core blocks of (bx, by,
// bz) rows, (nbx, nby, nbz) of them per axis, NB in (jx, jy, jz) order;
// window w; patch extents (ex, ey, ez) = (bx + 2w, by + 2w, bz + 2w) and P
// = ex * ey * ez patch sites in (lx, ly, lz) order.  Site (lx, ly, lz) of
// block (jx, jy, jz) is padded coordinate (jx bx + lx, jy by + ly, jz bz +
// lz), which is cube row ((jx bx + lx - w) mod cells, ...) per axis.
//
// block_patches (patch_build_kernel): (B, N, C) -> (B, NB, P, C).  A thread
// writes V-byte vectors of the contiguous output (16 bytes where the row
// length and both buffers' alignment allow, else 8, 4, 2 or 1) and reads
// each straight from the unpadded cube row its site wraps to: an exact
// copy of any dtype.  The threads of a block are `lanes` a row (one a
// vector) by 256 / lanes sites; each takes `sites` sites of one patch
// (blockIdx.y), so that a block copies ~16 KiB and a thread splits a site
// into (lx, ly, lz) once for its vectors.
//
// patches_fold (patch_fold_kernel): (B, NB, P, C) -> (B, N, C), f32 or
// bf16 in and out.  A thread owns V-element vectors of one cube row and
// builds that row's sum from the (block, site) entries that cover it, in
// exactly the association tree of the plain version (the strided
// slice-adds and the ring folds of ops/kernels/block_layout.py
// patches_fold_plain, which are the JAX package's):
//   F(px, py, pz) = 0 + sum over ascending lx of (0 + sum over ascending ly
//                   of (0 + sum over ascending lz of acc[block, site])),
//     over the (j, l) of each axis with j b + l = p (ascending l is
//     descending j);
//   the row's value = sum over z's padded coordinates (core, then ring) of
//     (sum over y's of (sum over x's of F)), where an axis' coordinates are
//     the core g + w and, for g >= cells - w or g < w, the ring g - cells + w
//     or g + cells + w (cells >= 2w, so a row has at most one ring an axis).
// In bf16 every add rounds to bf16 (round to nearest even), as the plain
// version's bf16 += does, so f32 and bf16 results equal the plain
// version's bit for bit.  Computing the fold per output row, rather than
// scattering each patch entry into its row, is what keeps that order: a
// scatter would need float atomics (an order that changes from launch to
// launch) or a zero-filled cube and one pass per slice, which is what the
// plain version costs.  Each input entry lies in exactly one row's tree,
// so it is still read once.  Where 2w <= every side of the core (the
// routes' windows and cores), a row lies in at most two entries an axis:
// the thread loads all (up to eight) before it adds, so that they are in
// flight together, and a row takes `lanes` threads, one a 16-byte vector
// (one thread a row where its vectors are narrower: it then walks the
// tree once for all of them).  Other geometries take
// patch_fold_loop_kernel, which walks the same tree in loops.
//
// Names: no kernel name here contains a pattern of the benchmark's kernel
// buckets (benchmark_torch/yardstick/buckets.py), so a profile files them
// with PyTorch's own passes, which they replace.

#include <cuda_runtime.h>

#include <cstdint>

#include "segment_sum.cuh"

namespace {

using segsum::Pack;

const int kThreads = 256;
const int kMaxGridY = 65535;

struct Geometry {
  int cells, w;
  int bx, by, bz;     // core
  int nbx, nby, nbz;  // blocks per axis
  int ex, ey, ez;     // patch extents
};

// a padded coordinate a in [-w, cells + w) -> its cube coordinate
__device__ __forceinline__ int wrap(int a, int cells) {
  return a < 0 ? a + cells : (a >= cells ? a - cells : a);
}

// a patch site -> its (lx, ly, lz)
struct Site {
  int lx, ly, lz;
  __device__ Site(int s, const Geometry& g) {
    const int t = s / g.ez;
    lz = s - t * g.ez;
    lx = t / g.ey;
    ly = t - lx * g.ey;
  }
};

// threadIdx.x: a vector of the row (striding by blockDim.x); threadIdx.y:
// a site, `sites` of them blockDim.y apart; blockIdx.x: a run of sites of
// one patch; blockIdx.y: the patch (striding by gridDim.y)
template <typename U>
__global__ void __launch_bounds__(kThreads)
patch_build_kernel(const U* __restrict__ src, U* __restrict__ dst,
                   long long patches, int units, int sites, Geometry g) {
  const int p_size = g.ex * g.ey * g.ez;
  const int nb = g.nbx * g.nby * g.nbz;
  const long long n = (long long)g.cells * g.cells * g.cells;
  const int s0 = blockIdx.x * blockDim.y * sites + threadIdx.y;
  for (long long pb = blockIdx.y; pb < patches; pb += gridDim.y) {
    const long long b = pb / nb;
    const int blk = (int)(pb - b * nb);
    const int jz = blk % g.nbz;
    const int jy = (blk / g.nbz) % g.nby;
    const int jx = blk / (g.nbz * g.nby);
    const U* sample = src + b * n * units;
    U* patch = dst + pb * p_size * units;
#pragma unroll 4
    for (int k = 0; k < sites; ++k) {
      const int s = s0 + k * blockDim.y;
      if (s >= p_size) break;
      const Site l(s, g);
      const int x = wrap(jx * g.bx + l.lx - g.w, g.cells);
      const int y = wrap(jy * g.by + l.ly - g.w, g.cells);
      const int z = wrap(jz * g.bz + l.lz - g.w, g.cells);
      const U* from = sample + ((long long)(x * g.cells + y) * g.cells + z) * units;
      U* to = patch + (long long)s * units;
      for (int u = threadIdx.x; u < units; u += blockDim.x) to[u] = from[u];
    }
  }
}

// V channels of a row in T: f32 values, or bf16 bit patterns in pairs
// (one in the low half for V 1) added with add.rn.bf16x2 / add.rn.bf16,
// which round the exact sum of two bf16 values once to bf16: what torch's
// bf16 add (an f32 add rounded to bf16) gives, since the sum of two bf16
// values rounds to the same bf16 through f32
template <typename T, int V>
struct Vec;

template <int V>
struct Vec<float, V> {
  float v[V];
  __device__ void load(const float* p) {
    const Pack<float, V> x = *reinterpret_cast<const Pack<float, V>*>(p);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = x.v[j];
  }
  __device__ void store(float* p) const {
    Pack<float, V> x;
#pragma unroll
    for (int j = 0; j < V; ++j) x.v[j] = v[j];
    *reinterpret_cast<Pack<float, V>*>(p) = x;
  }
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.0f;
  }
  __device__ Vec plus(const Vec& o) const {
    Vec r;
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[j] = __fadd_rn(v[j], o.v[j]);
    return r;
  }
};

template <int V>
struct Vec<uint16_t, V> {
  static constexpr int kWords = (V + 1) / 2;
  uint32_t h[kWords];
  __device__ void load(const uint16_t* p) {
    if constexpr (V == 1) {
      h[0] = *p;
    } else {
      const Pack<uint32_t, kWords> x =
          *reinterpret_cast<const Pack<uint32_t, kWords>*>(p);
#pragma unroll
      for (int j = 0; j < kWords; ++j) h[j] = x.v[j];
    }
  }
  __device__ void store(uint16_t* p) const {
    if constexpr (V == 1) {
      *p = (uint16_t)h[0];
    } else {
      Pack<uint32_t, kWords> x;
#pragma unroll
      for (int j = 0; j < kWords; ++j) x.v[j] = h[j];
      *reinterpret_cast<Pack<uint32_t, kWords>*>(p) = x;
    }
  }
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < kWords; ++j) h[j] = 0u;
  }
  __device__ Vec plus(const Vec& o) const {
    Vec r;
    if constexpr (V == 1) {
      unsigned short a = (unsigned short)h[0], b = (unsigned short)o.h[0], d;
      asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
      r.h[0] = d;
    } else {
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r.h[j]) : "r"(h[j]), "r"(o.h[j]));
    }
    return r;
  }
};

// 0 + x in T: x, with a negative zero made positive (the plain version's
// sums start from a zero-filled buffer)
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> from_zero(const Vec<T, V>& x) {
  Vec<T, V> z;
  z.zero();
  return z.plus(x);
}

// the blocks j of one axis whose patch holds padded coordinate p (site l =
// p - j b in [0, e)), from the highest j (the lowest l) down: [lo, hi]
struct Span {
  int hi, lo;
  __device__ Span(int p, int b, int e, int nblocks) {
    hi = min(p / b, nblocks - 1);
    const int over = p - e + 1;
    lo = over > 0 ? (over + b - 1) / b : 0;
  }
};

// the padded coordinates of cube coordinate c on one axis: the core's,
// then the ring's where c lies within w of a face; returns their count
__device__ __forceinline__ int padded(int c, int cells, int w, int (&p)[2]) {
  p[0] = c + w;
  if (c >= cells - w) {
    p[1] = c - cells + w;
    return 2;
  }
  if (c < w) {
    p[1] = c + cells + w;
    return 2;
  }
  return 1;
}

// F(px, py, pz) of one sample's patches (acc points at the sample's block
// 0) for the V channels at c0
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> padded_sum(const T* __restrict__ acc,
                                                int c, int c0,
                                                const Geometry& g, int px,
                                                int py, int pz) {
  const int p_size = g.ex * g.ey * g.ez;
  const Span sx(px, g.bx, g.ex, g.nbx), sy(py, g.by, g.ey, g.nby),
      sz(pz, g.bz, g.ez, g.nbz);
  Vec<T, V> out;
  out.zero();
  for (int jx = sx.hi; jx >= sx.lo; --jx) {
    const int lx = px - jx * g.bx;
    Vec<T, V> ys;
    ys.zero();
    for (int jy = sy.hi; jy >= sy.lo; --jy) {
      const int ly = py - jy * g.by;
      Vec<T, V> zs;
      zs.zero();
      for (int jz = sz.hi; jz >= sz.lo; --jz) {
        const int lz = pz - jz * g.bz;
        const long long blk = ((long long)jx * g.nby + jy) * g.nbz + jz;
        Vec<T, V> x;
        x.load(acc + (blk * p_size + (lx * g.ey + ly) * g.ez + lz) * c + c0);
        zs = zs.plus(x);
      }
      ys = ys.plus(zs);
    }
    out = out.plus(ys);
  }
  return out;
}

// any geometry: a thread's (row, vector) walks the row's tree in loops
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
patch_fold_loop_kernel(const T* __restrict__ acc, T* __restrict__ out,
                       long long rows, int c, Geometry g) {
  const int units = c / V;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * units) return;
  const long long row = i / units;
  const int c0 = (int)(i - row * units) * V;
  const long long n = (long long)g.cells * g.cells * g.cells;
  const long long b = row / n;
  const int r = (int)(row - b * n);
  const int z = r % g.cells;
  const int y = (r / g.cells) % g.cells;
  const int x = r / (g.cells * g.cells);
  const long long nb = (long long)g.nbx * g.nby * g.nbz;
  const T* sample = acc + b * nb * g.ex * g.ey * g.ez * c;
  int px[2], py[2], pz[2];
  const int nx = padded(x, g.cells, g.w, px);
  const int ny = padded(y, g.cells, g.w, py);
  const int nz = padded(z, g.cells, g.w, pz);
  Vec<T, V> zsum;
  for (int iz = 0; iz < nz; ++iz) {
    Vec<T, V> ysum;
    for (int iy = 0; iy < ny; ++iy) {
      Vec<T, V> xsum;
      for (int ix = 0; ix < nx; ++ix) {
        const Vec<T, V> f =
            padded_sum<T, V>(sample, c, c0, g, px[ix], py[iy], pz[iz]);
        xsum = ix == 0 ? f : xsum.plus(f);
      }
      ysum = iy == 0 ? xsum : ysum.plus(xsum);
    }
    zsum = iz == 0 ? ysum : zsum.plus(ysum);
  }
  zsum.store(out + row * c + c0);
}

// one axis of a cube row's fold where the row lies in at most two patches
// along the axis (2w <= the core's side): the offsets (in patch rows:
// this axis' share of block * P + site) of its one or two entries, in the
// tree's order (the core's padded coordinate, its blocks from the highest,
// then the ring's); `two`: both lie in the core's padded coordinate;
// `ring`: the second lies in the ring's
struct Axis2 {
  int off[2];
  int n;
  bool two, ring;
  __device__ Axis2(int c, int cells, int w, int b, int e, int nblocks,
                   int block_stride, int site_stride) {
    int p[2];
    const int np = padded(c, cells, w, p);
    const Span core(p[0], b, e, nblocks);
    off[0] = core.hi * block_stride + (p[0] - core.hi * b) * site_stride;
    off[1] = 0;
    two = core.lo < core.hi;
    ring = !two && np == 2;
    if (two) {
      off[1] = core.lo * block_stride + (p[0] - core.lo * b) * site_stride;
    } else if (ring) {
      const Span r(p[1], b, e, nblocks);
      off[1] = r.hi * block_stride + (p[1] - r.hi * b) * site_stride;
    }
    n = (two || ring) ? 2 : 1;
  }
};

// 2w <= every side of the core: a row lies in at most 2 x 2 x 2 patch
// entries, loaded first (up to eight 16-byte loads in flight a thread),
// then added in the plain version's tree.  threadIdx.x: a vector of the
// row (striding by blockDim.x); threadIdx.y and blockIdx.x: the row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
patch_fold_kernel(const T* __restrict__ acc, T* __restrict__ out, int rows,
                  int units, Geometry g) {
  using W = Vec<T, V>;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int cube = g.cells * g.cells * g.cells;
  const int b = row / cube;
  const int r = row - b * cube;
  const int t = r / g.cells;
  const int z = r - t * g.cells;
  const int x = t / g.cells;
  const int y = t - x * g.cells;
  const int p_size = g.ex * g.ey * g.ez;
  const Axis2 ax(x, g.cells, g.w, g.bx, g.ex, g.nbx,
                 g.nby * g.nbz * p_size, g.ey * g.ez);
  const Axis2 ay(y, g.cells, g.w, g.by, g.ey, g.nby, g.nbz * p_size, g.ez);
  const Axis2 az(z, g.cells, g.w, g.bz, g.ez, g.nbz, p_size, 1);
  const int c = units * V;
  const T* sample =
      acc + (long long)b * g.nbx * g.nby * g.nbz * p_size * c;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    W v[2][2][2];
#pragma unroll
    for (int ix = 0; ix < 2; ++ix)
#pragma unroll
      for (int iy = 0; iy < 2; ++iy)
#pragma unroll
        for (int iz = 0; iz < 2; ++iz) {
          if (ix < ax.n && iy < ay.n && iz < az.n) {
            v[ix][iy][iz].load(
                sample +
                (long long)(ax.off[ix] + ay.off[iy] + az.off[iz]) * c + u * V);
          } else {
            v[ix][iy][iz].zero();
          }
        }
    // z: for every (ix, iy), the sum over each z slot (core, ring)
    W zs[2][2][2];
#pragma unroll
    for (int ix = 0; ix < 2; ++ix)
#pragma unroll
      for (int iy = 0; iy < 2; ++iy) {
        zs[ix][iy][0] = from_zero(v[ix][iy][0]);
        if (az.two) zs[ix][iy][0] = zs[ix][iy][0].plus(v[ix][iy][1]);
        zs[ix][iy][1] = from_zero(v[ix][iy][1]);
      }
    // y: for every (ix, z slot), the sum over each y slot
    W ys[2][2][2];
#pragma unroll
    for (int ix = 0; ix < 2; ++ix)
#pragma unroll
      for (int sz = 0; sz < 2; ++sz) {
        ys[ix][sz][0] = from_zero(zs[ix][0][sz]);
        if (ay.two) ys[ix][sz][0] = ys[ix][sz][0].plus(zs[ix][1][sz]);
        ys[ix][sz][1] = from_zero(zs[ix][1][sz]);
      }
    // x: F of every (y slot, z slot) and x slot; then the rings folded,
    // x, then y, then z
    W xr[2][2];
#pragma unroll
    for (int sy = 0; sy < 2; ++sy)
#pragma unroll
      for (int sz = 0; sz < 2; ++sz) {
        W f0 = from_zero(ys[0][sz][sy]);
        if (ax.two) f0 = f0.plus(ys[1][sz][sy]);
        xr[sy][sz] = ax.ring ? f0.plus(from_zero(ys[1][sz][sy])) : f0;
      }
    W yr[2];
#pragma unroll
    for (int sz = 0; sz < 2; ++sz)
      yr[sz] = ay.ring ? xr[0][sz].plus(xr[1][sz]) : xr[0][sz];
    const W res = az.ring ? yr[0].plus(yr[1]) : yr[0];
    res.store(out + (long long)row * c + u * V);
  }
}

Geometry geometry(int cells, int w, int bx, int by, int bz) {
  return Geometry{cells,       w,           bx,          by,
                  bz,          cells / bx,  cells / by,  cells / bz,
                  bx + 2 * w,  by + 2 * w,  bz + 2 * w};
}

bool valid(const Geometry& g) {
  return g.w >= 0 && g.bx > 0 && g.by > 0 && g.bz > 0 && g.cells >= 2 * g.w &&
         g.cells % g.bx == 0 && g.cells % g.by == 0 && g.cells % g.bz == 0;
}

// a block of `lanes` threads a row (x) and 256 / lanes rows (y)
dim3 row_block(int lanes) {
  return dim3((unsigned)lanes, (unsigned)(kThreads / lanes));
}

template <typename U>
cudaError_t launch_build(const void* src, void* dst, long long patches,
                         int units, int lanes, int sites, const Geometry& g,
                         cudaStream_t stream) {
  const int p_size = g.ex * g.ey * g.ez;
  const dim3 block = row_block(lanes);
  const int per = (int)block.y * sites;
  const dim3 grid((unsigned)((p_size + per - 1) / per),
                  (unsigned)(patches < kMaxGridY ? patches : kMaxGridY));
  patch_build_kernel<U><<<grid, block, 0, stream>>>(
      (const U*)src, (U*)dst, patches, units, sites, g);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_fold(const void* acc, void* out, long long rows, int c,
                        int lanes, const Geometry& g, cudaStream_t stream) {
  const int units = c / V;
  if (2 * g.w <= g.bx && 2 * g.w <= g.by && 2 * g.w <= g.bz &&
      rows <= 0x7FFFFFFFLL) {
    const dim3 block = row_block(lanes);
    patch_fold_kernel<T, V>
        <<<(unsigned)((rows + block.y - 1) / block.y), block, 0, stream>>>(
            (const T*)acc, (T*)out, (int)rows, units, g);
  } else {
    const long long threads = rows * units;
    patch_fold_loop_kernel<T, V>
        <<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
           stream>>>((const T*)acc, (T*)out, rows, c, g);
  }
  return cudaGetLastError();
}

}  // namespace

// values (b, cells^3, C) -> patches (b, NB, P, C), rows of row_bytes bytes
// copied in vec_bytes vectors (16, 8, 4, 2 or 1, dividing row_bytes and
// both buffers' alignment) by `lanes` threads a row (1 to 256), `sites`
// rows a thread; cells >= 2 window, the core tiles the cube.
extern "C" int block_patches_forward(const void* values, void* patches,
                                     long long b, long long row_bytes,
                                     int vec_bytes, int lanes, int sites,
                                     int cells, int window, int bx, int by,
                                     int bz, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(cells, window, bx, by, bz);
  if (!valid(g) || vec_bytes <= 0 || row_bytes % vec_bytes || lanes < 1 ||
      lanes > kThreads || sites < 1)
    return (int)cudaErrorInvalidValue;
  const long long units = row_bytes / vec_bytes;
  if (units > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long n_patches = b * g.nbx * g.nby * g.nbz;
  if (n_patches * units == 0) return cudaSuccess;
  switch (vec_bytes) {
    case 16: return (int)launch_build<uint4>(values, patches, n_patches, (int)units, lanes, sites, g, stream);
    case 8: return (int)launch_build<uint2>(values, patches, n_patches, (int)units, lanes, sites, g, stream);
    case 4: return (int)launch_build<uint32_t>(values, patches, n_patches, (int)units, lanes, sites, g, stream);
    case 2: return (int)launch_build<uint16_t>(values, patches, n_patches, (int)units, lanes, sites, g, stream);
    case 1: return (int)launch_build<uint8_t>(values, patches, n_patches, (int)units, lanes, sites, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// acc (b, NB, P, C) -> out (b, cells^3, C), both f32 (is_bf16 0) or both
// bf16 (1); vec (1, 2, 4, and 8 for bf16) divides C and both buffers'
// alignment; `lanes` threads a row (1 to 256) where 2 window <= every
// side of the core; cells >= 2 window, the core tiles the cube.
extern "C" int patches_fold_forward(const void* acc, void* out, long long b,
                                    int c, int vec, int lanes, int is_bf16,
                                    int cells, int window, int bx, int by,
                                    int bz, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(cells, window, bx, by, bz);
  if (!valid(g) || vec <= 0 || c % vec || lanes < 1 || lanes > kThreads)
    return (int)cudaErrorInvalidValue;
  const long long rows = b * cells * cells * cells;
  if (rows * c == 0) return cudaSuccess;
  switch (is_bf16 ? 16 + vec : vec) {
    case 4: return (int)launch_fold<float, 4>(acc, out, rows, c, lanes, g, stream);
    case 2: return (int)launch_fold<float, 2>(acc, out, rows, c, lanes, g, stream);
    case 1: return (int)launch_fold<float, 1>(acc, out, rows, c, lanes, g, stream);
    case 24: return (int)launch_fold<uint16_t, 8>(acc, out, rows, c, lanes, g, stream);
    case 20: return (int)launch_fold<uint16_t, 4>(acc, out, rows, c, lanes, g, stream);
    case 18: return (int)launch_fold<uint16_t, 2>(acc, out, rows, c, lanes, g, stream);
    case 17: return (int)launch_fold<uint16_t, 1>(acc, out, rows, c, lanes, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
