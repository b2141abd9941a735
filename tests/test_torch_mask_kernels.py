"""Port parity: block_masks, kernels H/I's plain versions (the int8/int4
mask-dot pair) and kernel J's plain version (the fused layer boundary).

block_masks is bit-equal to nbody_tpu/ops/blocked.block_masks (int4 after
unpacking).  H/I's plain versions equal mask_dot_gather/mask_dot_scatter
(Pallas, interpret mode on the CPU): exactly on one-hot masks and on small
general-valued ones (sums of a few exact bf16 products), scatters held to
atol 1e-5 all the same (f32 summation order).  The masked ops on integer
masks equal direct indexing and np.add.at (the mirror of
tests/test_banded.py:321-382), and the autograd pair reproduces the JAX
custom VJPs.  J's plain version meets fused_boundary_dot and
boundary_reference at tests/test_fused.py's tolerances: 1e-5 in f32, and
in bf16 rtol/atol 2e-2 (act) and rtol 2e-2 / atol 2e-1 (h1, s).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu.ops import blocked as jbl
from nbody_tpu.ops.knn import knn_periodic_lattice_batch as j_lattice
from nbody_tpu.ops.pallas import fused_kernels as JFK
from nbody_tpu.ops.pallas import mask_kernels as JMK

from nbody_tpu_torch.data.dataset import features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.ops import blocked as tbl
from nbody_tpu_torch.ops.kernels import fused_kernels as FK
from nbody_tpu_torch.ops.kernels import mask_kernels as MK

torch.set_num_threads(1)

CELLS, K, W, B = 8, 6, 2, 2
N = CELLS ** 3
CORES = [(4, 8, 8), (2, 2, 2)]


def _graph(seed=7):
    """A real lattice-kNN graph of synthetic cubes: idx (B, N, K) int32."""
    x = features_from_raw(synthetic_raw_cubes(B, CELLS, seed=seed))
    pos = x[..., :3] + 2.0 * CELLS + x[..., 3:6]
    return np.array(j_lattice(jnp.mod(jnp.asarray(pos) / (4.0 * CELLS), 1.0),
                              K, cells=CELLS, window=W), dtype=np.int32)


def _rand(shape, seed, bf16_exact=False):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if bf16_exact:
        a = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both_masks(idx, mask_dt, core=tbl.MASKED_CORE, drop=False):
    """(JAX masks, port masks) of one graph: int8, or int4 (port packed)."""
    jdt = jnp.int8 if mask_dt == "int8" else jnp.int4
    tdt = torch.int8 if mask_dt == "int8" else "int4"
    return (jbl.block_masks(jnp.asarray(idx), CELLS, W, dtype=jdt, core=core,
                            drop_self_slot0=drop),
            tbl.block_masks(_t(idx), CELLS, W, tdt, core, drop))


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("mask_dt", ["int8", "int4"])
def test_block_masks_bit_equal(mask_dt, core, drop):
    idx = _graph()
    jm, tm = _both_masks(idx, mask_dt, core, drop)
    p = tbl.patch_size(CELLS, W, core)
    et = int(np.prod(core)) * (K - 1 if drop else K)
    if mask_dt == "int8":
        assert tm.dtype == torch.int8 and tm.shape[2:] == (et, p)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    else:
        assert tm.dtype == torch.uint8 and tm.shape[2:] == (et, p // 2)
        np.testing.assert_array_equal(tbl.unpack_int4(tm).numpy(),
                                      np.asarray(jm.astype(jnp.int8)))
    assert MK.patch_width(tm) == p


def test_block_masks_float_and_refusals():
    idx = _graph(seed=3)
    core = (2, 2, 2)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tbl.block_masks(_t(idx), CELLS, W, tdt, core, True)
        want = jbl.block_masks(jnp.asarray(idx), CELLS, W, dtype=jdt, core=core,
                               drop_self_slot0=True)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError):
        tbl.block_masks(_t(idx), CELLS, W, torch.int32, core)
    with pytest.raises(ValueError):       # P = 5^3, odd: no int4 packing
        tbl.block_masks(_t(idx), CELLS, 1, "int4", (3, 3, 3))


def test_int4_packing_round_trip():
    v = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)
    packed = tbl.pack_int4(v)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 16)
    assert int(packed[0, 0]) == 0x98           # -8 low nibble, -7 high
    np.testing.assert_array_equal(tbl.unpack_int4(packed).numpy(), v.numpy())
    np.testing.assert_array_equal(
        tbl.unpack_int4(packed).numpy(),
        np.asarray(jnp.asarray(v.numpy()).astype(jnp.int4).astype(jnp.int8)))
    with pytest.raises(ValueError):
        tbl.pack_int4(torch.zeros((2, 3), dtype=torch.int8))
    with pytest.raises(ValueError):
        tbl.pack_int4(torch.full((2, 2), 8))


def _general_masks(seed, shape=(B, 4, 40, 24)):
    """Random int8 masks in [-3, 3]: the kernels are dense products."""
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(np.int8)


@pytest.mark.parametrize("kind,c", [("onehot", 1), ("onehot", 3), ("general", 8)])
@pytest.mark.parametrize("mask_dt", ["int8", "int4"])
def test_mask_dot_plain_matches_pallas(mask_dt, kind, c):
    if kind == "onehot":
        jm, tm = _both_masks(_graph(seed=c), mask_dt, (2, 2, 2), True)
    else:
        m = _general_masks(c)
        jm = jnp.asarray(m) if mask_dt == "int8" else jnp.asarray(m).astype(jnp.int4)
        tm = _t(m) if mask_dt == "int8" else tbl.pack_int4(_t(m))
    b, nb, et = tm.shape[:3]
    p = MK.patch_width(tm)
    pat, ev = _rand((b, nb, p, c), 10 + c), _rand((b, nb, et, c), 20 + c)
    got = MK.dot_gather(tm, _t(pat))
    want = np.asarray(JMK.mask_dot_gather(jm, jnp.asarray(pat)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if kind == "onehot":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    got = MK.dot_scatter(tm, _t(ev))
    want = np.asarray(JMK.mask_dot_scatter(jm, jnp.asarray(ev)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mask_dt", ["int8", "int4"])
def test_mask_pair_grads_match_jax_vjp(mask_dt):
    """Each op's gradient is the other op on the bf16-rounded cotangent,
    cast back to the primal's dtype (mask_kernels.py:117-150)."""
    m = _general_masks(5)
    jm = jnp.asarray(m) if mask_dt == "int8" else jnp.asarray(m).astype(jnp.int4)
    tm = _t(m) if mask_dt == "int8" else tbl.pack_int4(_t(m))
    b, nb, et, p = m.shape
    pat, ev = _rand((b, nb, p, 6), 30), _rand((b, nb, et, 6), 31)
    ct_g, ct_s = _rand(ev.shape, 32), _rand(pat.shape, 33)
    tpat, tev = _t(pat).requires_grad_(), _t(ev).requires_grad_()
    (gp,) = torch.autograd.grad(MK.mask_dot_gather(tm, tpat), tpat, _t(ct_g))
    (ge,) = torch.autograd.grad(MK.mask_dot_scatter(tm, tev), tev, _t(ct_s))
    _, vjp_g = jax.vjp(lambda a: JMK.mask_dot_gather(jm, a), jnp.asarray(pat))
    _, vjp_s = jax.vjp(lambda a: JMK.mask_dot_scatter(jm, a), jnp.asarray(ev))
    assert gp.dtype == ge.dtype == torch.float32
    np.testing.assert_allclose(gp.numpy(), np.asarray(vjp_g(jnp.asarray(ct_g))[0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(vjp_s(jnp.asarray(ct_s))[0]),
                               rtol=0, atol=1e-5)
    # bf16 primals get bf16 gradients
    tb = _t(pat).to(torch.bfloat16).requires_grad_()
    (gb,) = torch.autograd.grad(MK.mask_dot_gather(tm, tb), tb, _t(ct_g))
    assert gb.dtype == torch.bfloat16


@pytest.mark.parametrize("mask_dt", ["int8", "int4"])
def test_masked_int_ops_match_indexing(mask_dt):
    """Integer masks through ops/blocked's masked ops (kernels H/I's plain
    versions): gather == direct indexing and scatter == np.add.at for
    bf16-representable values; d(sum gather)/d(values) is the in-degree
    and d(sum scatter)/d(vals) == 1 (tests/test_banded.py:321-382)."""
    idx = _graph(seed=11)
    _, masks = _both_masks(idx, mask_dt)
    v = _t(_rand((B, N, 5), 40, True)).requires_grad_()
    vals = _t(_rand((B, N, K, 5), 41, True)).requires_grad_()
    g = tbl.masked_gather(v, masks, CELLS, W)
    s = tbl.masked_scatter_add(vals, masks, CELLS, W)
    for b in range(B):
        np.testing.assert_array_equal(g[b].detach().numpy(),
                                      v.detach().numpy()[b][idx[b]])
        ref = np.zeros((N, 5), np.float32)
        np.add.at(ref, idx[b].reshape(-1), vals.detach().numpy()[b].reshape(-1, 5))
        np.testing.assert_allclose(s[b].detach().numpy(), ref, atol=1e-5)
    (grad,) = torch.autograd.grad(g.sum(), v)
    deg = np.zeros((B, N), np.float32)
    for b in range(B):
        np.add.at(deg[b], idx[b].reshape(-1), 1.0)
    np.testing.assert_allclose(grad.numpy()[..., 0], deg, atol=1e-4)
    (grad_s,) = torch.autograd.grad(s.sum(), vals)
    np.testing.assert_allclose(grad_s.numpy(), 1.0, atol=1e-5)


def test_mask_wrappers_refuse_bad_inputs():
    m = _t(_general_masks(6))
    pat, ev = _t(_rand((B, 4, 24, 3), 60)), _t(_rand((B, 4, 40, 3), 61))
    with pytest.raises(ValueError):
        MK.dot_gather(m.to(torch.int32), pat)
    with pytest.raises(ValueError):
        MK.dot_gather(m, ev)                  # 40 rows, the masks have P 24
    with pytest.raises(ValueError):
        MK.dot_scatter(tbl.pack_int4(m), pat)
    with pytest.raises(ValueError):
        MK.dot_scatter(m[:1], ev)
    with pytest.raises(ValueError):
        MK.dot_gather(m.to("meta"), pat.to("meta"))
    with pytest.raises(ValueError):
        tbl.unpack_int4(m)


# Kernel I's tiling and fragment arithmetic (csrc/mask_kernels.cu,
# mask_scatter_kernel), checked here because the kernel runs only on a card.
SMEM_OPTIN = 232_448     # H100: dynamic shared memory one block may opt in to


def _grain(int4):
    """Rows of P in a 32-byte group of a mask row: the row map's unit."""
    return 64 if int4 else 32


@pytest.mark.parametrize("p", [216, 1152])
@pytest.mark.parametrize("c", [1, 3, 16, 32, 64, 80])
@pytest.mark.parametrize("int4", [False, True])
def test_scatter_tiling_fits(int4, c, p):
    tl = MK.scatter_tiling(p, c, int4)
    cfg = MK.scatter_cfg(int4, tl.nt)
    assert tl.row_tiles * tl.rows >= p > (tl.row_tiles - 1) * tl.rows
    assert 1 <= tl.warps <= cfg.max_warps and tl.rows_per_warp == cfg.rows_per_warp
    assert tl.rows_per_warp % _grain(int4) == 0
    assert cfg.edges % 16 == 0 and cfg.stages >= 2
    assert tl.nt * 8 >= min(c, 64) and tl.nt in (1, 2, 4, 8)
    assert tl.smem_bytes <= SMEM_OPTIN
    # f32 accumulators a thread, (rows / 16 m-tiles) x nt x 4 over 32
    # lanes, within the budget and 32 under the registers the launch
    # bounds leave a thread (16,384 per SM sub-partition, the warps of
    # min_blocks CTAs spread over 4 of them, in steps of 8)
    per_sp = -(-cfg.max_warps * cfg.min_blocks // 4)
    regs = min(255, 16384 // (32 * per_sp) // 8 * 8)
    assert tl.rows_per_warp * tl.nt // 4 <= min(MK.SCATTER_ACC_REGS, regs - 32)
    # the edge operand of a block is read once per row tile
    if c <= 16 and p <= 1152:
        assert tl.row_tiles == 1
    if c == 64 and p == 1152 and int4:
        assert tl.row_tiles <= 3


def _widen(vals, int4):
    """The kernel's widening of mask bytes ^ 0x80 (int8) or nibbles ^ 8
    (int4) to bf16.  int8: under the f32 exponent of 2^23, minus 2^23 +
    128, and the upper half of the f32 taken as the bf16 (its low half
    must be zero).  int4: the bf16 0x4300 | nibble (128 + nibble) minus 136
    in bf16."""
    vals = np.asarray(vals, dtype=np.uint32)
    if int4:
        bits = (np.uint32(0x4300) | vals).astype(np.uint16)
        wide = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        return wide - torch.tensor(136, dtype=torch.bfloat16)
    f = (np.uint32(0x4B000000) | vals).view(np.float32) - np.float32(8388736)
    bits = f.view(np.uint32)
    assert not (bits & np.uint32(0xFFFF)).any()
    return torch.from_numpy((bits >> np.uint32(16)).astype(np.uint16).view(np.int16)
                            ).view(torch.bfloat16)


@pytest.mark.parametrize("int4", [False, True])
def test_scatter_widening_is_exact(int4):
    if int4:
        nib = np.arange(16, dtype=np.uint32)
        want = np.where(nib >= 8, nib.astype(np.int64) - 16, nib)
        got = _widen(nib ^ 8, True)
    else:
        byte = np.arange(256, dtype=np.uint32)
        want = byte.astype(np.uint8).view(np.int8).astype(np.int64)
        got = _widen(byte ^ 0x80, False)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def _row_map(int4):
    """(lane, m16 tile mi, h) -> row of P in a 32-byte group: accumulator
    row g + 8h of tile mi (g = lane // 4) holds value 2mi + h of the word
    at byte 4g."""
    grain = _grain(int4)
    return {(lane, mi, h): (grain // 8) * (lane // 4) + 2 * mi + h
            for lane in range(32) for mi in range(grain // 16) for h in (0, 1)}


@pytest.mark.parametrize("int4", [False, True])
def test_scatter_fragments_reproduce_the_product(int4):
    """One warp's k16 step on one 32-byte group, emulated lane by lane as
    the kernel builds it: the A words, the widening into bf16 pairs, the
    m16n8k16 fragment layout and the row map of the epilogue give M^T . E
    of the group; the row map is a bijection onto the group's rows."""
    grain = _grain(int4)
    rmap = _row_map(int4)
    # the four lanes of a quad share rows (they own other columns): over
    # (g, mi, h) each row of the group comes once
    by_g = {(lane // 4, mi, h): r for (lane, mi, h), r in rmap.items()}
    assert sorted(by_g.values()) == list(range(grain))

    rng = np.random.default_rng(3)
    vals = rng.integers(-8, 8, (16, grain)) if int4 else rng.integers(-128, 128, (16, grain))
    m = tbl.pack_int4(_t(vals)).numpy() if int4 else vals.astype(np.int8).view(np.uint8)
    words = np.ascontiguousarray(m).view(np.uint32)            # (16 e, 8 words)
    e = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)).to(torch.bfloat16)
    n_mt = grain // 16
    a = torch.zeros((n_mt, 16, 16), dtype=torch.bfloat16)      # (tile, row, k)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for q, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
            w = np.uint32(words[k, g])
            if int4:
                x = w ^ np.uint32(0x88888888)
                lo, hi = x & np.uint32(0x0F0F0F0F), (x >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
            else:
                lo = hi = w ^ np.uint32(0x80808080)
            for mi in range(n_mt):
                jl, jh = (mi, mi) if int4 else (2 * mi, 2 * mi + 1)
                for h, (src, j) in enumerate(((lo, jl), (hi, jh))):
                    a[mi, g + 8 * h, k] = _widen([(int(src) >> (8 * j)) & 0xFF],
                                                 int4)[0]
    acc = torch.matmul(a.float(), e.float())                   # (tile, 16, 8)
    out = torch.zeros((grain, 8))
    for (lane, mi, h), r in rmap.items():
        out[r] = acc[mi, lane // 4 + 8 * h]
    want = torch.matmul(torch.from_numpy(vals.T.astype(np.float32)), e.float())
    assert torch.equal(out, want)


# Kernel H's tiling and fragment arithmetic (csrc/mask_kernels.cu,
# mask_gather_kernel), checked here because the kernel runs only on a card.
@pytest.mark.parametrize("et", [200, 3328])
@pytest.mark.parametrize("p", [216, 1152])
@pytest.mark.parametrize("c", [1, 3, 16, 32, 64, 80])
@pytest.mark.parametrize("int4", [False, True])
def test_gather_tiling_fits(int4, c, p, et):
    tl = MK.gather_tiling(et, c, int4)
    cfg = MK.gather_cfg(tl.nt)
    assert tl.row_tiles * tl.rows >= et > (tl.row_tiles - 1) * tl.rows
    assert 1 <= tl.warps <= cfg.max_warps and tl.rows_per_warp == cfg.rows_per_warp
    assert tl.stages == cfg.stages >= 2
    # a warp's rows are one TMA box (at most 256 rows) of m16 tiles
    assert tl.rows_per_warp % 16 == 0 and tl.rows_per_warp <= 256
    assert tl.nt * 8 >= min(c, 64) and tl.nt in (1, 2, 4, 8)
    # the ring: per stage the mask tile (every row, GATHER_SPAN bytes) and
    # its patch rows (GATHER_SPAN p values int8, twice as many int4)
    span = MK.GATHER_SPAN
    stage = tl.rows * span + span * (2 if int4 else 1) * MK.gather_ldx(tl.nt) * 2
    assert tl.smem_bytes >= tl.stages * stage and tl.smem_bytes <= SMEM_OPTIN
    # f32 accumulators a thread, (rows / 16 m-tiles) x nt x 4, within the
    # budget and 32 under the registers the launch bounds leave a thread
    # (16,384 per SM sub-partition, the consumer warps and the producer
    # spread over 4 of them, in steps of 8)
    per_sp = -(-(cfg.max_warps + 1) // 4)
    regs = min(255, 16384 // (32 * per_sp) // 8 * 8)
    assert tl.rows_per_warp // 16 * tl.nt * 4 <= min(MK.GATHER_ACC_REGS, regs - 32)
    # at the route's shape a block's patches are read once per row tile:
    # twice at C <= 8, four times at C 16 and 32, eight at C 64
    if et == 3328 and p == 1152:
        assert tl.row_tiles <= (2 if c <= 8 else 4 if c <= 32 else 8)


def _k_order(int4):
    """Kernel H's k permutation (gather_k_phys): row l of a stage's patch
    tile holds patch row order[l] of its 16-row (int8) / 32-row (int4)
    group."""
    order = []
    for l in range(32 if int4 else 16):
        q = l & 15
        if int4:
            order.append(((q & 7) >> 1) * 8 + ((l >> 4) & 1) * 4 + (q & 1) * 2 + (q >> 3))
        else:
            order.append(((q & 7) >> 1) * 4 + (q >> 3) * 2 + (q & 1))
    return order


@pytest.mark.parametrize("int4", [False, True])
def test_gather_fragments_reproduce_the_product(int4):
    """One warp's 16-byte chunk of one m16 tile, emulated lane by lane as
    the kernel builds it: the A words from the raw mask bytes, the
    widening into bf16 pairs, the m16n8k16 fragment layout of each k16 step
    (one int8, two int4) and the patch rows the producer stores in k order
    give M . X of the chunk exactly; the k order is a bijection."""
    order = _k_order(int4)
    assert sorted(order) == list(range(len(order)))
    rng = np.random.default_rng(5)
    k = len(order)                                             # p of the chunk
    vals = rng.integers(-8, 8, (16, k)) if int4 else rng.integers(-128, 128, (16, k))
    m = tbl.pack_int4(_t(vals)).numpy() if int4 else vals.astype(np.int8).view(np.uint8)
    words = np.ascontiguousarray(m).view(np.uint32)            # (16 rows, 4 words)
    # integer-valued patches: every product and sum is exact in f32
    x = torch.from_numpy(rng.integers(-8, 9, (k, 8)).astype(np.float32))
    steps = 2 if int4 else 1
    a = torch.zeros((steps, 16, 16), dtype=torch.bfloat16)     # (step, row, k slot)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for ks in range(steps):
            for reg, (row, slot) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                               (g, 2 * t + 8), (g + 8, 2 * t + 8))):
                w = np.uint32(words[row, t])
                if int4:
                    xw = int(w ^ np.uint32(0x88888888))
                    src = (xw >> 4) & 0x0F0F0F0F if reg >= 2 else xw & 0x0F0F0F0F
                    pair = [(src >> (8 * j)) & 0xFF for j in (2 * ks, 2 * ks + 1)]
                else:
                    xw = int(w ^ np.uint32(0x80808080))
                    pair = [(xw >> (8 * j)) & 0xFF for j in ((0, 1) if reg < 2 else (2, 3))]
                a[ks, row, slot:slot + 2] = _widen(pair, int4)
    tile = x[order]                                            # the stage's patch rows
    got = sum(torch.matmul(a[ks].float(), tile[16 * ks:16 * ks + 16]) for ks in range(steps))
    want = torch.matmul(torch.from_numpy(vals.astype(np.float32)), x)
    assert torch.equal(got, want)


def _fused_setup(dtype):
    """tests/test_fused.py's inputs: block masks of a lattice graph at core
    (2, 2, 2), C 8, q 4, in one dtype; numpy f32 arrays + the port masks."""
    rng = np.random.default_rng(7)
    idx = _graph(seed=17)[:1]
    tdt = getattr(torch, dtype)
    masks = tbl.block_masks(_t(idx), CELLS, W, tdt, (2, 2, 2))
    jmasks = jbl.block_masks(jnp.asarray(idx), CELLS, W, dtype=getattr(jnp, dtype),
                             core=(2, 2, 2))
    np.testing.assert_array_equal(masks.float().numpy(),
                                  np.asarray(jmasks.astype(jnp.float32)))
    b, nb, et, p = masks.shape
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, nb, p, 8), (b, nb, et, 8), (8, 4), (8, 4))]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]
    return masks, jmasks, arrs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_matches_jax(dtype):
    masks, jmasks, arrs = _fused_setup(dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = FK.fused_boundary_dot(masks, *[_t(a).to(tdt) for a in arrs])
    jargs = [jnp.asarray(a).astype(jdt) for a in arrs]
    kern = JFK.fused_boundary_dot(jmasks, *jargs)
    ref = JFK.boundary_reference(jmasks, *jargs)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    for want in (kern, ref):
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
            assert g.shape == w.shape
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            else:
                atol = 2e-2 if i == 0 else 2e-1
                np.testing.assert_allclose(g, w, rtol=2e-2, atol=atol)


def test_fused_plain_is_the_layer_boundary_math():
    """J's (gather + per-edge chain + scatter) equals the port's own masked
    ops composed (tests/test_fused.py:66-81), in f32 on int8 masks of the
    same graph: kernel H's gather, relu, the weight products, kernel I."""
    masks, _, (pat, a, w1, w2) = _fused_setup("float32")
    int8 = masks.to(torch.int8)
    pat = torch.from_numpy(pat).to(torch.bfloat16).float()   # H rounds to bf16
    _, h1, s = FK.fused_boundary_dot(masks, pat, _t(a), _t(w1), _t(w2))
    e = torch.relu(MK.dot_gather(int8, pat) + _t(a))
    hw = torch.matmul(e, _t(w2))
    np.testing.assert_allclose(h1.numpy(), torch.matmul(e, _t(w1)).numpy(),
                               rtol=1e-5, atol=1e-5)
    # kernel I rounds its operand to bf16: compare within that rounding
    np.testing.assert_allclose(s.numpy(), MK.dot_scatter(int8, hw).numpy(),
                               rtol=2 ** -7, atol=2e-2)


def test_fused_wrapper_refuses_bad_inputs():
    masks, _, (pat, a, w1, w2) = _fused_setup("float32")
    with pytest.raises(ValueError):
        FK.fused_boundary_dot(masks, _t(pat)[..., :4], _t(a), _t(w1), _t(w2))
    with pytest.raises(ValueError):
        FK.fused_boundary_dot(masks.to(torch.int8), _t(pat), _t(a), _t(w1), _t(w2))
    with pytest.raises(ValueError):
        FK.fused_boundary_dot(masks, _t(pat), _t(a), _t(w1), _t(w2)[:4])
    # any activation runs in the plain version; tanh is not relu
    act, _, _ = FK.fused_boundary_dot(masks, _t(pat), _t(a), _t(w1), _t(w2),
                                      act=torch.tanh)
    assert float(act.min()) < 0
