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
