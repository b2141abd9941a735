"""Port parity for kernel J (the fused layer boundary): its plain version
against JAX's fused_boundary_dot, the bf16 kernel's tiling, and a
lane-by-lane emulation of the kernel's fragment maps.

* The plain version (what the wrapper runs for CPU tensors) equals
  nbody_tpu.ops.pallas.fused_kernels.fused_boundary_dot (Pallas, interpret
  mode on the CPU) and its boundary_reference on block masks of a lattice
  graph at core (2,2,2), at every (C, q) pair of shiftinv's interior layer
  boundaries (q 64 and q 3 among them), in f32 and bf16, with one numpy
  seed: f32 within 1e-5; bf16 act within rtol / atol 2e-2 and h1, s within
  rtol 2e-2 / atol 2e-1 (tests/test_fused.py's tolerances).
* fused_tiling gives a plan for every shape of the kernel's path, refuses
  shapes it cannot cover, and never asks for more shared memory than the
  limit it is given.
* The kernel splits P over the CTAs of a cluster and the warps of a CTA,
  reads its A fragments with ldmatrix from a stage that TMA swizzled by
  128 bytes, and reads the chain's act tile and W as fragments.  numpy
  emulations of those maps, lane by lane, reproduce M . patches, M^T . hw
  and act . W exactly on small integer values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nbody_tpu.ops import blocked as jbl
from nbody_tpu.ops.knn import knn_periodic_lattice_batch as j_lattice
from nbody_tpu.ops.pallas import fused_kernels as JFK

from nbody_tpu_torch.data.dataset import features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.ops import blocked as tbl
from nbody_tpu_torch.ops.kernels import fused_kernels as FK

torch.set_num_threads(1)

CELLS, K, W = 8, 6, 2
H100_SMEM = 232_448
BOUNDARIES = [(32, 32), (32, 64), (64, 64), (64, 32), (32, 16), (16, 3)]


def _graph(seed=17):
    x = features_from_raw(synthetic_raw_cubes(1, CELLS, seed=seed))
    pos = x[..., :3] + 2.0 * CELLS + x[..., 3:6]
    return np.array(j_lattice(jnp.mod(jnp.asarray(pos) / (4.0 * CELLS), 1.0),
                              K, cells=CELLS, window=W), dtype=np.int32)


@pytest.fixture(scope="module")
def graph():
    return _graph()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,q", BOUNDARIES)
def test_fused_plain_matches_jax_at_the_boundaries(graph, dtype, c, q):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    masks = tbl.block_masks(torch.from_numpy(graph), CELLS, W, tdt, (2, 2, 2))
    jmasks = jbl.block_masks(jnp.asarray(graph), CELLS, W, dtype=jdt, core=(2, 2, 2))
    b, nb, et, p = masks.shape
    rng = np.random.default_rng(c * 100 + q)
    arrs = [rng.normal(size=s).astype(np.float32) * sc
            for s, sc in (((b, nb, p, c), 1.0), ((b, nb, et, c), 0.5),
                          ((c, q), 0.3), ((c, q), 0.3))]
    got = FK.fused_boundary_dot(masks, *[torch.from_numpy(a).to(tdt) for a in arrs])
    jargs = [jnp.asarray(a).astype(jdt) for a in arrs]
    for want in (JFK.fused_boundary_dot(jmasks, *jargs),
                 JFK.boundary_reference(jmasks, *jargs)):
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
            assert g.shape == w.shape
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_allclose(g, w, rtol=2e-2,
                                           atol=2e-2 if i == 0 else 2e-1)


# ---------------------------------------------------------------------------
# the tiling
# ---------------------------------------------------------------------------

PATH = [(1152, c, q) for c, q in BOUNDARIES] + [(1728, 32, 32)]


@pytest.mark.parametrize("p,c,q", PATH + [(216, 16, 16), (288, 8, 8), (216, 64, 64)])
@pytest.mark.parametrize("limit", [H100_SMEM, 166_912])
def test_fused_tiling_covers_the_path(p, c, q, limit):
    tl = FK.fused_tiling(p, c, q, limit)
    assert tl.smem_bytes <= limit
    assert tl.smem_bytes == FK.smem_bytes(tl.nc, tl.nq, tl.rows, tl.stages,
                                          tl.cluster, tl.warps, tl.p_cta, True)
    assert tl.nc * 8 >= c and tl.nq * 8 >= q and tl.nc in (2, 4, 8) and tl.nq in (2, 4, 8)
    assert tl.cluster in FK.CLUSTERS and tl.p_cta % FK.BOX_COLS == 0
    assert tl.cluster * tl.p_cta >= p > (tl.cluster - 1) * tl.p_cta
    assert tl.warps * tl.mt * 16 >= tl.p_cta          # the warps cover the slice
    assert tl.rows // 16 <= tl.warps <= FK.MAX_WARPS
    assert tl.rows in (16, 32) and (tl.rows == 16 or tl.nc < 8)
    assert 2 <= tl.stages <= 4
    # a thread's s accumulators and patch fragments fit 96 registers
    assert tl.mt * (4 * tl.nq + 2 * tl.nc) <= 96


def test_fused_tiling_closes_the_parents_gap():
    """q 64 at P 1,152 and C = q = 32 at P 1,728, which the parent refused
    (its f32 s and a 32-row bf16 mask tile over one SM), take clusters of
    CTAs."""
    for p, c, q in ((1152, 32, 64), (1152, 64, 64), (1728, 32, 32)):
        tl = FK.fused_tiling(p, c, q, H100_SMEM)
        assert tl.cluster > 1
        assert 4 * p * q + 2 * 32 * p > H100_SMEM
    assert FK.fused_tiling(1152, 32, 32, H100_SMEM).cluster == 2


@pytest.mark.parametrize("p,c,q", [(1150, 32, 32), (1152, 65, 32), (1152, 32, 65),
                                   (0, 32, 32), (1152, 0, 32)])
def test_fused_tiling_refuses_shapes_it_cannot_cover(p, c, q):
    with pytest.raises(ValueError):
        FK.fused_tiling(p, c, q, H100_SMEM)


@pytest.mark.parametrize("p,c,q", PATH)
def test_fused_tiling_refuses_a_card_too_small(p, c, q):
    with pytest.raises(ValueError):
        FK.fused_tiling(p, c, q, 16_000)
    # the smallest cluster that fits is chosen: a smaller one is refused
    tl = FK.fused_tiling(p, c, q, H100_SMEM)
    for k in FK.CLUSTERS:
        if k < tl.cluster:
            with pytest.raises(ValueError):
                FK.fused_tiling(p, c, q, H100_SMEM, cluster=k)


# ---------------------------------------------------------------------------
# lane-by-lane emulation of the kernel's fragment maps
# ---------------------------------------------------------------------------

def _ldmatrix(mem, addrs, trans):
    """ldmatrix .x4 (or .x2 with 16 addresses): lane l gives the byte
    address of row l % 8 of matrix l / 8 in `mem` (uint16 elements);
    returns regs[lane][j] = (low, high) values of matrix j."""
    mats = [np.stack([mem[a // 2: a // 2 + 8] for a in addrs[8 * j: 8 * j + 8]])
            for j in range(len(addrs) // 8)]
    out = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out.append([(m[2 * t, g], m[2 * t + 1, g]) if trans else
                    (m[g, 2 * t], m[g, 2 * t + 1]) for m in mats])
    return out


def _mma(acc, a_regs, b_regs):
    """m16n8k16: acc (16, 8) += A (16 x 16) . B (16 x 8) from the lanes'
    fragments (a: 4 (low, high) pairs, b: 2)."""
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j, (r, k) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                    (g + 8, 2 * t + 8))):
            a[r, k:k + 2] = a_regs[lane][j]
        for j in range(2):
            b[2 * t + 8 * j: 2 * t + 8 * j + 2, g] = b_regs[lane][j]
    return acc + a @ b


def _stage(m, p_begin, nbox, rows):
    """One CTA's stage as TMA writes it: box bx holds columns [p_begin + 64
    bx, +64) of the rows, 128 bytes a row, the 16-byte granule index XOR the
    row's low 3 bits; columns past the mask arrive as zeros."""
    mem = np.zeros(nbox * rows * 64)
    for bx in range(nbox):
        for row in range(rows):
            for col in range(64):
                pc = p_begin + 64 * bx + col
                v = m[row, pc] if pc < m.shape[1] else 0.0
                off = bx * rows * 128 + row * 128 + (((col // 8) ^ (row & 7)) << 4) + 2 * (col % 8)
                mem[off // 2] = v
    return mem


def _mask_addr(rows, tile, row, gran):
    return (tile >> 2) * rows * 128 + row * 128 + ((((tile & 3) << 1) + gran) ^ (row & 7)) * 16


@pytest.mark.parametrize("p,c,q,k,mt,warps,rows", [
    (216, 16, 8, 2, 4, 2, 32),      # two CTAs, the last one ragged
    (200, 32, 16, 1, 4, 4, 16),     # P not a multiple of 16
    (1152, 64, 64, 4, 2, 10, 16),   # the C = q = 64 boundary's cluster of 4
])
def test_fused_fragment_maps_reproduce_the_products(p, c, q, k, mt, warps, rows):
    """The kernel's maps, lane by lane: each warp's M . patches partial over
    its m16 tiles of its CTA's columns (A by ldmatrix from the swizzled
    stage, B from its patch fragments), summed over warps and CTAs, is
    M . patches; each warp's rows of s from M^T . hw (A by ldmatrix.trans
    from the same stage, B by ldmatrix.trans from hw [R][LDH]) are M^T . hw;
    exact on small integers."""
    rng = np.random.default_rng(p + c + q)
    m = rng.integers(-2, 3, size=(rows, p)).astype(np.float64)
    pat = rng.integers(-3, 4, size=(p, c)).astype(np.float64)
    hw = rng.integers(-3, 4, size=(rows, q)).astype(np.float64)
    nc, nq = FK.col_tiles(c), FK.col_tiles(q)
    ldh = nq * 8 + 8
    per_cta = -(-p // k)
    p_cta = -(-per_cta // 64) * 64
    assert warps * mt * 16 >= p_cta
    hw_mem = np.zeros(rows * ldh)
    for r in range(rows):
        hw_mem[r * ldh: r * ldh + q] = hw[r]
    e = np.zeros((rows, nc * 8))
    s = np.zeros((p, q))
    for rank in range(k):
        p_begin = rank * p_cta
        p_end = min(p, p_begin + p_cta)
        nbox = -(-(p_end - p_begin) // 64)
        mem = _stage(m, p_begin, p_cta // 64, rows)
        for w in range(warps):
            for mi in range(mt):
                tile = w * mt + mi
                if p_begin + tile * 16 >= p_end:
                    continue
                assert tile // 4 < nbox
                for ei in range(rows // 16):
                    # M . patches: A (rows e, k = p) by ldmatrix
                    addrs = [_mask_addr(rows, tile, ei * 16 + (l & 7) + 8 * ((l >> 3) & 1), l >> 4)
                             for l in range(32)]
                    a = _ldmatrix(mem, addrs, False)
                    for nj in range(nc):
                        bregs = []
                        for lane in range(32):
                            g, t = lane // 4, lane % 4
                            pair = []
                            for h in range(2):
                                pr = p_begin + tile * 16 + 2 * t + 8 * h
                                cc = nj * 8 + g
                                pair.append(tuple(pat[x, cc] if x < p_end and cc < c else 0.0
                                                  for x in (pr, pr + 1)))
                            bregs.append(pair)
                        e[ei * 16: ei * 16 + 16, nj * 8: nj * 8 + 8] = _mma(
                            e[ei * 16: ei * 16 + 16, nj * 8: nj * 8 + 8], a, bregs)
                    # M^T . hw: A (rows p, k = e) by ldmatrix.trans
                    addrs = [_mask_addr(rows, tile, ei * 16 + (l & 7) + 8 * (l >> 4), (l >> 3) & 1)
                             for l in range(32)]
                    a = _ldmatrix(mem, addrs, True)
                    ld_k = [((l >> 3) & 1) * 8 + (l & 7) for l in range(32)]
                    ld_n = [(l >> 4) * 8 for l in range(32)]
                    for nq_ in range(nq):
                        u = nq_ // 2
                        b = _ldmatrix(hw_mem, [((ei * 16 + ld_k[l]) * ldh + u * 16 + ld_n[l]) * 2
                                               for l in range(32)], True)
                        bregs = [b[l][2 * (nq_ % 2): 2 * (nq_ % 2) + 2] for l in range(32)]
                        acc = np.zeros((16, 8))
                        acc = _mma(acc, a, bregs)
                        r0 = p_begin + tile * 16
                        cols = min(8, q - nq_ * 8)
                        for r in range(16):
                            if r0 + r < p_end and cols > 0:
                                s[r0 + r, nq_ * 8: nq_ * 8 + cols] += acc[r, :cols]
    np.testing.assert_array_equal(e[:, :c], m @ pat)
    assert not e[:, c:].any()
    np.testing.assert_array_equal(s, m.T @ hw)


@pytest.mark.parametrize("c,q", [(16, 3), (32, 32), (64, 64), (8, 8)])
def test_fused_chain_fragment_maps_reproduce_the_weight_products(c, q):
    """The chain's weight products: A by ldmatrix from the act tile [R][C8
    + 8] bf16 (zeros past C), W's B fragments by ldmatrix.trans from W
    [KS * 16][LDH] (zeros past q), 16 rows and k16 step ks at a time; the
    product is act . W."""
    rng = np.random.default_rng(c * q)
    nc, nq = FK.col_tiles(c), FK.col_tiles(q)
    c8, ldc, ldh = nc * 8, nc * 8 + 8, nq * 8 + 8
    rows = 32
    act = np.zeros((rows, c8))
    act[:, :c] = rng.integers(-3, 4, size=(rows, c))
    w = rng.integers(-3, 4, size=(c, q)).astype(np.float64)
    amem = np.zeros(rows * ldc)
    for r in range(rows):
        amem[r * ldc: r * ldc + c8] = act[r]
    wmem = np.zeros(nc // 2 * 16 * ldh)
    for r in range(c):
        wmem[r * ldh: r * ldh + q] = w[r]
    h = np.zeros((rows, nq * 8))
    ld_k = [((l >> 3) & 1) * 8 + (l & 7) for l in range(32)]
    ld_n = [(l >> 4) * 8 for l in range(32)]
    a_row = [(l & 7) + 8 * ((l >> 3) & 1) for l in range(32)]
    a_col = [8 * (l >> 4) for l in range(32)]
    for rg in range(rows // 16):
        for ks in range(nc // 2):
            a = _ldmatrix(amem, [((rg * 16 + a_row[l]) * ldc + ks * 16 + a_col[l]) * 2
                                 for l in range(32)], False)
            for nq_ in range(nq):
                b = _ldmatrix(wmem, [((ks * 16 + ld_k[l]) * ldh + (nq_ // 2) * 16 + ld_n[l]) * 2
                                     for l in range(32)], True)
                bregs = [b[l][2 * (nq_ % 2): 2 * (nq_ % 2) + 2] for l in range(32)]
                sl = np.s_[rg * 16: rg * 16 + 16, nq_ * 8: nq_ * 8 + 8]
                h[sl] = _mma(h[sl], a, bregs)
    np.testing.assert_array_equal(h[:, :q], act[:, :c] @ w)
    assert not h[:, q:].any()
