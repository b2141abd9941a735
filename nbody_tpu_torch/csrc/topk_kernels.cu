// Kernel A: the lattice kNN -- its k-smallest selection (topk_min) and the
// whole search with the candidate distances fused in (lattice_knn).
//
// Both replace nbody_tpu/ops/pallas/topk_kernels.py : topk_min_pallas
// (_topk_kernel), which ran k argmin+mask passes over a VMEM-resident row
// tile of distances that XLA had computed from 125 rolls of the position
// cube (nbody_tpu/ops/knn.py:173-239).  Same result, bit for bit: the k
// slots of the smallest values in ascending order, ties to the lowest slot,
// under the clamp encoding  NaN -> FLT_MAX/2,  +inf and anything larger
// than FLT_MAX/4 -> FLT_MAX/4  (topk_kernels.py:34-35), so that
// NaN > +inf > finite and k distinct slots come out even when a row holds
// fewer than k finite candidates.  That is jax.lax.top_k(-d2, k) order.
// The selection is one thread per row keeping a sorted list of the
// smallest keys in registers (TopK below, shared by both kernels): each
// candidate is one 64-bit key, its encoded value's order-preserving bits
// above its slot, so that the key order is exactly (value, lowest slot)
// and the result does not depend on the order the candidates arrive in.
// A key not below the largest kept one is skipped, which changes nothing.
//
// topk_min: d2 (rows, m) f32 -> (rows, k) slots.  What bounds it on the
// H100: memory.  Each row is m*4 bytes read once (m = 125 at window 2) and
// k*4 bytes written, a few compares per byte.  A block stages a tile of
// rows in shared memory with coalesced loads, then each thread scans its
// row in slot order.  With m odd the per-thread row stride in shared
// memory is odd, so the scan is free of bank conflicts.
//
// lattice_knn: positions (b, cells^3, 3) f32 in grid order -> (b, cells^3,
// k) int32 neighbor ids, so that the (rows, m) distances never reach device
// memory.  Particle n originates at lattice site unflatten(n); its m =
// (2w+1)^3 candidates are the sites at offsets (dx, dy, dz) in [-w, w]^3,
// wrapped per axis, in lexicographic (dx, dy, dz) order (the roll order of
// the plain version), with w = min(window, (cells-1)//2).  One thread per
// particle; a block takes a 4 x 8 x 8 tile of sites and first stages the
// tile and its +-w halo of positions in shared memory with coalesced loads
// (8 x 12 x 12 x 12 B = 13.8 KB at w = 2).  The particle itself is slot 0
// (its -1 is below every distance); each thread then scores the other
// candidates shell by shell, nearest first, and selects the k - 1 smallest
// as topk_min does.  Going outward, the kept list is tight after the first
// shell (27 sites), so the 98 sites of the second rarely insert, and a
// warp rarely runs the insertion for one of them.  The distance is the
// plain version's expression tree, each operation rounded on its own: d = c - p,
// d - box*rint(d/box) (round half to even, as torch.round), the squares
// summed as ((x + y) + z).  The intrinsics (__fsub_rn, __fmul_rn, ...) keep
// nvcc from contracting a multiply and an add into an fma, which rounds
// once and would break near-ties differently.  Slots are decoded to ids
// with the per-axis wrap and staged through shared memory, so that each
// z-run of the tile's output (8 particles x k ids) is stored coalesced.
// What bounds it: the FP32 issue of ~20 operations per candidate (about
// 0.33 GFLOP at 32^3 b4 w2) against 8.9 MB of positions in and ids out.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

__device__ __forceinline__ float clamp_encode(float d) {
  return isnan(d) ? FLT_MAX * 0.5f : fminf(d, FLT_MAX * 0.25f);
}

// (clamp-encoded value, slot) as one unsigned 64-bit key whose order is the
// selection's: the value's f32 bits mapped to an order-preserving unsigned
// (negatives flipped; -0 first made +0, which compares equal to it), then
// the slot, so that equal values go to the lowest slot.  Keys are distinct,
// so the selection does not depend on the order the candidates come in.
__device__ __forceinline__ unsigned long long topk_key(float d, int slot) {
  const unsigned u = __float_as_uint(clamp_encode(d) + 0.0f);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)slot;
}

// The KMAX smallest keys seen, ascending, in registers (every index is a
// compile-time constant after unrolling); a key not below the largest kept
// one changes nothing and is skipped.
template <int KMAX>
struct TopK {
  unsigned long long key[KMAX];

  __device__ __forceinline__ TopK() {
#pragma unroll
    for (int t = 0; t < KMAX; ++t) key[t] = ~0ull;   // above every real key
  }

  __device__ __forceinline__ void push(unsigned long long x) {
    if (x >= key[KMAX - 1]) return;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {               // one bubble pass
      const unsigned long long lo = x < key[t] ? x : key[t];
      x = x < key[t] ? key[t] : x;
      key[t] = lo;
    }
  }

  __device__ __forceinline__ int slot(int t) const { return (int)(unsigned)key[t]; }
};

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
  TopK<KMAX> top;
  for (int j = 0; j < m; ++j) top.push(topk_key(row[j], j));
  int32_t* o = out + (row0 + threadIdx.x) * k;
#pragma unroll
  for (int t = 0; t < KMAX; ++t)
    if (t < k) o[t] = top.slot(t);
}

// the lattice tile of one block: TX x TY x TZ sites, one thread each
constexpr int TX = 4, TY = 8, TZ = 8, kTileThreads = TX * TY * TZ;

__device__ __forceinline__ int wrap(int v, int cells) {
  v %= cells;
  return v < 0 ? v + cells : v;
}

// a - b under the min-image convention, each operation rounded on its own.
// For a box that is a power of two, d / box is exactly d * (1 / box), and
// the multiply spares the division's instruction sequence.
template <bool POW2_BOX>
__device__ __forceinline__ float min_image(float a, float b, float box,
                                           float inv_box) {
  const float d = __fsub_rn(a, b);
  const float q = POW2_BOX ? __fmul_rn(d, inv_box) : __fdiv_rn(d, box);
  return __fsub_rn(d, __fmul_rn(box, rintf(q)));
}

template <int KMAX, bool POW2_BOX>
__global__ void __launch_bounds__(kTileThreads)
lattice_knn_kernel(const float* __restrict__ pos, int32_t* __restrict__ out,
                   int cells, int w, int k, float box, int tiles_y,
                   int tiles_z) {
  extern __shared__ float smem[];   // halo positions, then the ids staged
  const int hy = TY + 2 * w, hz = TZ + 2 * w, hx = TX + 2 * w;
  int tile = blockIdx.x;
  const int z0 = (tile % tiles_z) * TZ;
  tile /= tiles_z;
  const int y0 = (tile % tiles_y) * TY;
  const int x0 = (tile / tiles_y) * TX;
  const long long n = (long long)cells * cells * cells;
  const long long cube = (long long)blockIdx.y * n;
  const float* p = pos + cube * 3;

  // stage the tile and its halo: runs of hz sites x 3 floats along z
  const int halo = hx * hy * hz * 3;
  for (int i = threadIdx.x; i < halo; i += blockDim.x) {
    int s = i / 3;
    const int comp = i - s * 3;
    const int sz = s % hz;
    s /= hz;
    const int sy = s % hy, sx = s / hy;
    const int gx = wrap(x0 - w + sx, cells), gy = wrap(y0 - w + sy, cells),
              gz = wrap(z0 - w + sz, cells);
    smem[i] = __ldg(p + (((long long)gx * cells + gy) * cells + gz) * 3 + comp);
  }
  __syncthreads();

  const int lz = threadIdx.x % TZ, ly = (threadIdx.x / TZ) % TY,
            lx = threadIdx.x / (TZ * TY);
  const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
  const bool active = x < cells && y < cells && z < cells;
  const int m = 2 * w + 1;
  TopK<KMAX> top;                   // the k - 1 nearest others
  if (active) {
    const float* c0 = smem + (((lx + w) * hy + (ly + w)) * hz + (lz + w)) * 3;
    const float px = c0[0], py = c0[1], pz = c0[2];
    const float inv_box = 1.0f / box;
    // shell by shell in Chebyshev radius r, the nearest first, so that the
    // kept list is tight early and the outer shells rarely insert (and the
    // warp rarely diverges); the keys make the result order-free
    for (int r = 1; r <= w; ++r) {
      for (int dx = -r; dx <= r; ++dx) {
        const bool face_x = dx == -r || dx == r;
        for (int dy = -r; dy <= r; ++dy) {
          const int step = (face_x || dy == -r || dy == r) ? 1 : 2 * r;
          const float* row = c0 + (dx * hy + dy) * hz * 3;
          for (int dz = -r; dz <= r; dz += step) {
            const float* cand = row + dz * 3;
            const float ex = min_image<POW2_BOX>(cand[0], px, box, inv_box);
            const float ey = min_image<POW2_BOX>(cand[1], py, box, inv_box);
            const float ez = min_image<POW2_BOX>(cand[2], pz, box, inv_box);
            const float d2 = __fadd_rn(
                __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
            top.push(topk_key(d2, ((dx + w) * m + (dy + w)) * m + (dz + w)));
          }
        }
      }
    }
  }
  __syncthreads();                  // every thread is done with the halo

  // decode the slots to ids and stage them: thread t's k ids at t*k, the
  // particle itself first (its -1 is below every distance)
  int32_t* ids = reinterpret_cast<int32_t*>(smem);
  if (active) {
    ids[threadIdx.x * k] = (x * cells + y) * cells + z;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (t < k - 1) {
        const int s = top.slot(t);
        const int nx = wrap(x + s / (m * m) - w, cells);
        const int ny = wrap(y + (s / m) % m - w, cells);
        const int nz = wrap(z + s % m - w, cells);
        ids[threadIdx.x * k + 1 + t] = (nx * cells + ny) * cells + nz;
      }
    }
  }
  __syncthreads();
  // each (lx, ly) z-run of TZ particles is TZ*k consecutive ids of out
  const int run = TZ * k;
  for (int i = threadIdx.x; i < TX * TY * run; i += blockDim.x) {
    const int r = i / run, within = i - r * run;
    const int rx = x0 + r / TY, ry = y0 + r % TY, rz = z0 + within / k;
    if (rx < cells && ry < cells && rz < cells)
      out[(cube + ((long long)rx * cells + ry) * cells + z0) * k + within] =
          ids[i];
  }
}

}  // namespace

// Shared-memory budget of one topk_min block: the 48 KB a launch gets
// without an opt-in attribute.
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

// Shared memory of one lattice_knn block (bytes): the halo, reused for the
// staged ids.  The wrapper refuses windows whose halo exceeds what a block
// may opt in to (lattice_knn_max_smem).
extern "C" int lattice_knn_smem_bytes(int w, int k) {
  const int halo = (TX + 2 * w) * (TY + 2 * w) * (TZ + 2 * w) * 3 * 4;
  const int staged = kTileThreads * k * 4;
  return halo > staged ? halo : staged;
}

extern "C" int lattice_knn_max_smem(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return v;
}

// pos (b, cells^3, 3) f32 contiguous, grid order -> out (b, cells^3, k)
// int32 neighbor ids.  w = min(window, (cells-1)//2) is the clamped half
// width, 1 <= k <= min((2w+1)^3, 32).  Returns cudaGetLastError().
extern "C" int lattice_knn_f32(const float* pos, int32_t* out, int b,
                               int cells, int w, int k, float box, int device,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0) return 0;
  const int tiles_x = (cells + TX - 1) / TX, tiles_y = (cells + TY - 1) / TY,
            tiles_z = (cells + TZ - 1) / TZ;
  const dim3 grid((unsigned)(tiles_x * tiles_y * tiles_z), (unsigned)b);
  const int smem = lattice_knn_smem_bytes(w, k);
  int exp2 = 0;
  const bool pow2 = box > 0.0f && frexpf(box, &exp2) == 0.5f;
  // the list holds the k - 1 others
  auto kernel = k <= 9 ? (pow2 ? lattice_knn_kernel<8, true> : lattice_knn_kernel<8, false>)
              : k <= 17 ? (pow2 ? lattice_knn_kernel<16, true> : lattice_knn_kernel<16, false>)
                        : (pow2 ? lattice_knn_kernel<32, true> : lattice_knn_kernel<32, false>);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kTileThreads, smem, stream>>>(pos, out, cells, w, k, box,
                                               tiles_y, tiles_z);
  return (int)cudaGetLastError();
}
