"""Port parity: ops/blocked.py and kernels D-G's plain versions.

The block layout helpers (cube <-> block-major, dilated patches, the
overlap-add fold, per-edge patch positions) are bit-equal to
nbody_tpu/ops/blocked.py for the cores (4,8,8), (4,4,8) and (2,2,2).
Kernels D/E's plain versions equal idx_dot_gather/idx_dot_scatter (Pallas,
interpret mode on the CPU) and F/G's equal block_*_pallas(interpret=True)
in both ``fast`` modes: gathers exactly, scatters to atol 1e-5 (f32
summation order).  The autograd pair reproduces the JAX custom VJPs,
including the cast of the cotangent to bf16.  The block plan the
scatters E and G run over matches a numpy reference (stable order, ties
by edge id, out-of-range positions last), their plain versions are
bit-equal to a sequential numpy f32 sum in edge order, and the wrappers
refuse a plan that does not fit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu.ops import blocked as jbl
from nbody_tpu.ops.knn import knn_periodic_lattice_batch as j_lattice
from nbody_tpu.ops.pallas import idx_kernels as JIK
from nbody_tpu.ops.pallas.block_kernels import (block_gather_pallas,
                                                block_scatter_pallas)

from nbody_tpu_torch.data.dataset import features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.ops import blocked as tbl
from nbody_tpu_torch.ops.kernels import block_kernels as BK
from nbody_tpu_torch.ops.kernels import idx_kernels as IK
from nbody_tpu_torch.ops.route import Route

torch.set_num_threads(1)

CELLS, K, W, B = 8, 6, 2, 2
N = CELLS ** 3
CORES = [(4, 8, 8), (4, 4, 8), (2, 2, 2)]


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


@pytest.mark.parametrize("core", CORES)
def test_block_transposes_bit_equal(core):
    v = _rand((B, N, 5), 0)
    got = tbl.cube_to_blocks(_t(v), CELLS, core)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbl.cube_to_blocks(jnp.asarray(v), CELLS, core)))
    np.testing.assert_array_equal(
        tbl.blocks_to_cube(got, CELLS, core).numpy(),
        np.asarray(jbl.blocks_to_cube(jnp.asarray(got.numpy()), CELLS, core)))
    np.testing.assert_array_equal(tbl.blocks_to_cube(got, CELLS, core).numpy(), v)
    e = _rand((B, N, K, 3), 1)
    eb = tbl.edges_cube_to_blocks(_t(e), CELLS, core)
    np.testing.assert_array_equal(
        eb.numpy(), np.asarray(jbl.edges_cube_to_blocks(jnp.asarray(e), CELLS, core)))
    np.testing.assert_array_equal(
        tbl.nodes_blocks_to_cube(got, CELLS, core).numpy(),
        np.asarray(jbl.nodes_blocks_to_cube(jnp.asarray(got.numpy()), CELLS, core)))


@pytest.mark.parametrize("core", CORES)
def test_patches_and_fold_bit_equal(core):
    v = _rand((B, N, 4), 2)
    patches = tbl.block_patches(_t(v), CELLS, W, core)
    want = np.asarray(jbl.block_patches(jnp.asarray(v), CELLS, W, core))
    np.testing.assert_array_equal(patches.numpy(), want)
    assert patches.shape[2] == tbl.patch_size(CELLS, W, core)
    acc = _rand(want.shape, 3)
    np.testing.assert_array_equal(
        tbl.patches_fold(_t(acc), CELLS, W, core).numpy(),
        np.asarray(jbl.patches_fold(jnp.asarray(acc), CELLS, W, core)))


def test_patches_fold_pair_gradcheck_f64():
    """block_patches and patches_fold are each other's gradient."""
    rng = np.random.default_rng(12)
    cells, w, core = 4, 1, (2, 2, 2)
    v = torch.from_numpy(rng.normal(size=(1, cells ** 3, 2))).requires_grad_()
    acc = torch.from_numpy(rng.normal(size=(1, 8, 64, 2))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a: tbl.block_patches(a, cells, w, core), (v,))
    assert torch.autograd.gradcheck(
        lambda a: tbl.patches_fold(a, cells, w, core), (acc,))


@pytest.mark.parametrize("core", CORES)
def test_edge_positions_bit_equal(core):
    idx = _graph()
    got = tbl.edge_block_positions(_t(idx), CELLS, W, core)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbl.edge_block_positions(jnp.asarray(idx),
                                                         CELLS, W, core)))
    got = tbl.block_positions(_t(idx), CELLS, W, core, drop_self_slot0=True)
    want = np.asarray(jbl.block_positions(jnp.asarray(idx), CELLS, W, core,
                                          drop_self_slot0=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[2] == np.prod(core) * (K - 1)


@pytest.mark.parametrize("core", CORES)
def test_masked_ops_match(core):
    """The index route's gather (exact) and scatter (atol 1e-5, f32
    accumulation of bf16 terms), cube and block-major forms, self slot
    dropped as the registry builds it."""
    idx = _graph()
    v, ev = _rand((B, N, 5), 4), _rand((B, N, K, 5), 5)
    jpos = jbl.block_positions(jnp.asarray(idx), CELLS, W, core, drop_self_slot0=True)
    tplan = tbl.block_index_plan(_t(idx), CELLS, W, core, drop_self_slot0=True)
    kw = dict(core=core, self_slot0=True)
    np.testing.assert_array_equal(
        tbl.masked_gather(_t(v), tplan, CELLS, W, **kw).numpy(),
        np.asarray(jbl.masked_gather(jnp.asarray(v), jpos, CELLS, W, **kw)))
    np.testing.assert_allclose(
        tbl.masked_scatter_add(_t(ev), tplan, CELLS, W, **kw).numpy(),
        np.asarray(jbl.masked_scatter_add(jnp.asarray(ev), jpos, CELLS, W, **kw)),
        rtol=0, atol=1e-5)
    eb = jbl.edges_cube_to_blocks(jnp.asarray(ev), CELLS, core)
    np.testing.assert_array_equal(
        tbl.masked_gather_blocks(_t(v), tplan, CELLS, W, **kw).numpy(),
        np.asarray(jbl.masked_gather_blocks(jnp.asarray(v), jpos, CELLS, W, **kw)))
    np.testing.assert_allclose(
        tbl.masked_scatter_add_blocks(_t(np.array(eb)), tplan, CELLS, W,
                                      **kw).numpy(),
        np.asarray(jbl.masked_scatter_add_blocks(eb, jpos, CELLS, W, **kw)),
        rtol=0, atol=1e-5)


def _positions(c, seed, nb=4, et=40, p=24):
    """Random positions with a few outside [0, P) (they read 0 / drop)."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-2, p + 2, (B, nb, et)).astype(np.int32)
    return pos, _rand((B, nb, p, c), seed + 1), _rand((B, nb, et, c), seed + 2)


@pytest.mark.parametrize("c", [1, 6, 16])
def test_idx_dot_plain_matches_pallas(c):
    pos, pat, ev = _positions(c, 10 + c)
    p = pat.shape[2]
    plan = BK.block_plan(_t(pos), p)
    got = IK.dot_gather(_t(pos), _t(pat))
    assert got.dtype == torch.bfloat16
    want = np.asarray(JIK.idx_dot_gather(jnp.asarray(pos), jnp.asarray(pat)))
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        IK.idx_dot_gather(plan, _t(pat)).float().numpy(), want)
    got = IK.dot_scatter(plan, _t(ev), p)
    want = np.asarray(JIK.idx_dot_scatter(jnp.asarray(pos), jnp.asarray(ev), p))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_kernels_plain_match_pallas(fast, dtype):
    pos, pat, ev = _positions(6, 20)
    pos = np.clip(pos, 0, pat.shape[2] - 1)   # Pallas one-hot: in range
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpat, jev = jnp.asarray(pat).astype(jdt), jnp.asarray(ev).astype(jdt)
    got = BK.block_gather(_t(pos), _t(pat).to(tdt), fast=fast)
    want = np.asarray(block_gather_pallas(jnp.asarray(pos), jpat, fast=fast,
                                          interpret=True))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    p = pat.shape[2]
    got = BK.block_scatter(BK.block_plan(_t(pos), p), _t(ev).to(tdt), p, fast=fast)
    want = np.asarray(block_scatter_pallas(jnp.asarray(pos), jev, (p, 1, 1),
                                           fast=fast, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_idx_pair_grads_match_jax_vjp():
    """Each op's gradient is the other op on the bf16-rounded cotangent,
    cast back to the primal's dtype (idx_kernels.py:146-162)."""
    pos, pat, ev = _positions(8, 30)
    pos = np.clip(pos, 0, pat.shape[2] - 1)
    p = pat.shape[2]
    ct_g, ct_s = _rand(ev.shape, 33), _rand(pat.shape, 34)
    tpat, tev = _t(pat).requires_grad_(), _t(ev).requires_grad_()
    plan = BK.block_plan(_t(pos), p)
    (gp,) = torch.autograd.grad(IK.idx_dot_gather(plan, tpat), tpat,
                                _t(ct_g).to(torch.bfloat16))
    (ge,) = torch.autograd.grad(IK.idx_dot_scatter(plan, tev, p), tev, _t(ct_s))
    jpos = jnp.asarray(pos)
    _, vjp_g = jax.vjp(lambda a: JIK.idx_dot_gather(jpos, a), jnp.asarray(pat))
    _, vjp_s = jax.vjp(lambda a: JIK.idx_dot_scatter(jpos, a, p), jnp.asarray(ev))
    assert gp.dtype == ge.dtype == torch.float32
    np.testing.assert_allclose(gp.numpy(), np.asarray(vjp_g(jnp.asarray(ct_g))[0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(vjp_s(jnp.asarray(ct_s))[0]))


def test_masked_route_grads_match_jax():
    """Gradients through the whole index route (patch views, kernels D/E,
    fold) against jax.vjp of the JAX masked ops, in bf16, on the core with
    the most blocks."""
    core = (2, 2, 2)
    idx = _graph(seed=9)
    v, ev = _rand((B, N, 4), 40, True), _rand((B, N, K, 4), 41, True)
    ct_g, ct_s = _rand((B, N, K, 4), 42, True), _rand((B, N, 4), 43, True)
    jpos = jbl.block_positions(jnp.asarray(idx), CELLS, W, core, drop_self_slot0=True)
    tplan = tbl.block_index_plan(_t(idx), CELLS, W, core, drop_self_slot0=True)
    kw = dict(core=core, self_slot0=True)
    bf = torch.bfloat16
    tv, te = _t(v).to(bf).requires_grad_(), _t(ev).to(bf).requires_grad_()
    (gv,) = torch.autograd.grad(tbl.masked_gather(tv, tplan, CELLS, W, **kw), tv,
                                _t(ct_g).to(bf))
    (ge,) = torch.autograd.grad(tbl.masked_scatter_add(te, tplan, CELLS, W, **kw),
                                te, _t(ct_s).to(bf))
    jb = jnp.bfloat16
    _, vjp_g = jax.vjp(lambda a: jbl.masked_gather(a, jpos, CELLS, W, **kw),
                       jnp.asarray(v).astype(jb))
    _, vjp_s = jax.vjp(lambda a: jbl.masked_scatter_add(a, jpos, CELLS, W, **kw),
                       jnp.asarray(ev).astype(jb))
    want_g = np.asarray(vjp_g(jnp.asarray(ct_g).astype(jb))[0].astype(jnp.float32))
    want_s = np.asarray(vjp_s(jnp.asarray(ct_s).astype(jb))[0].astype(jnp.float32))
    # the gather's gradient sums bf16 terms (kernel E, then the fold in
    # bf16, in JAX's order of adds); XLA may keep f32 inside a fusion, so
    # the two round at different points: within 2 bf16 ulps (2^-6 relative)
    np.testing.assert_allclose(gv.float().numpy(), want_g, rtol=2 ** -6, atol=1e-2)
    np.testing.assert_array_equal(ge.float().numpy(), want_s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_route_ops_match_indexing(dtype):
    """The --impl block route of ops/route (kernels F/G with fast = bf16
    input, exact either way) == direct indexing, with each op the other's
    gradient."""
    idx = _graph(seed=11)
    tdt = getattr(torch, dtype)
    v = _t(_rand((B, N, 3), 50, True)).to(tdt).requires_grad_()
    ev = _t(_rand((B, N, K, 3), 51, True)).to(tdt).requires_grad_()
    block, direct = Route.block(_t(idx), CELLS, W), Route.direct(_t(idx))
    g = block.gather(v)
    assert g.dtype == tdt
    np.testing.assert_array_equal(g.detach().float().numpy(),
                                  direct.gather(v).detach().float().numpy())
    s = block.scatter_add(ev)
    np.testing.assert_allclose(s.detach().float().numpy(),
                               direct.scatter_add(ev).detach().float().numpy(),
                               rtol=2 ** -7, atol=1e-5)
    ct = torch.ones_like(g)
    (gv,) = torch.autograd.grad(g, v, ct)
    np.testing.assert_array_equal(gv.float().numpy()[..., 0],
                                  direct.counts().numpy())
    np.testing.assert_array_equal(block.counts().numpy(), direct.counts().numpy())


def test_select_wrappers_refuse_bad_inputs():
    pos, pat, ev = (_t(a) for a in _positions(3, 60))
    plan = BK.block_plan(pos, pat.shape[2])
    with pytest.raises(ValueError):
        IK.dot_gather(pos.to("meta"), pat.to("meta"))
    with pytest.raises(ValueError):
        BK.block_scatter(plan._replace(pos=pos.long()), ev, pat.shape[2])
    with pytest.raises(ValueError):
        BK.block_gather(pos[:1], pat)
    with pytest.raises(ValueError):
        IK.dot_scatter(plan, ev[..., 0], pat.shape[2])
    with pytest.raises(ValueError):
        tbl.block_geometry(CELLS, W, (3, 4, 4))


@pytest.mark.parametrize("c,elem,ptr,want", [
    (64, 2, 0, 8), (6, 2, 0, 2), (9, 2, 0, 1), (64, 4, 0, 4), (6, 4, 0, 2),
    (9, 4, 0, 1), (64, 2, 4, 2), (32, 4, 8, 2)])
def test_vector_width_divides_channels_and_alignment(c, elem, ptr, want):
    v = BK.vector_width(c, elem, 4096, 4096 + ptr)
    assert v == want and c % v == 0 and ptr % (v * elem) == 0


def _plan_reference(pos, p):
    """The block plan in numpy: site keys blk*P + pos (no site: B*NB*P),
    a stable argsort (ties by ascending edge id) and each site's first
    edge."""
    b, nb, et = pos.shape
    blk = np.arange(b * nb).reshape(b, nb, 1)
    valid = (pos >= 0) & (pos < p)
    keys = np.where(valid, blk * p + pos, b * nb * p).reshape(-1)
    order = np.argsort(keys, kind="stable")
    offsets = np.searchsorted(keys[order], np.arange(b * nb * p + 1), side="left")
    return order, offsets


@pytest.mark.parametrize("core", CORES)
def test_block_plan_matches_numpy(core):
    """The plan of the registry's positions (self slot dropped) and of
    the block route's (every slot), and of random positions with some
    outside [0, P): equal to the numpy reference; the out-of-range edges
    come last, past offsets[-1]."""
    idx = _graph(seed=13)
    p = tbl.patch_size(CELLS, W, core)
    plans = [tbl.block_index_plan(_t(idx), CELLS, W, core, drop_self_slot0=drop)
             for drop in (True, False)]
    rng = np.random.default_rng(sum(core))
    rand = rng.integers(-3, p + 3, (B, 5, 77)).astype(np.int32)
    plans.append(BK.block_plan(_t(rand), p))
    for plan in plans:
        pos = plan.pos.numpy()
        assert plan.order.dtype == plan.offsets.dtype == torch.int32
        order, offsets = _plan_reference(pos, p)
        np.testing.assert_array_equal(plan.order.numpy(), order)
        np.testing.assert_array_equal(plan.offsets.numpy(), offsets)
        flat = pos.reshape(-1)
        tail = plan.order.numpy()[plan.offsets[-1]:]
        assert ((flat[tail] < 0) | (flat[tail] >= p)).all()
        np.testing.assert_array_equal(
            plan.site_degree().numpy().reshape(B, -1, p).sum(-1),
            ((pos >= 0) & (pos < p)).sum(-1))
    np.testing.assert_array_equal(
        plans[0].pos.numpy(), tbl.block_positions(_t(idx), CELLS, W, core,
                                                  drop_self_slot0=True).numpy())


def _sequential_sum(pos, vals, p):
    """Per (batch, block, site) f32 sums, added one edge at a time in
    ascending edge order (np.add.at is unbuffered and sequential)."""
    b, nb, et, c = vals.shape
    out = np.zeros((b, nb, p + 1, c), np.float32)
    ids = np.where((pos >= 0) & (pos < p), pos, p)
    for bi in range(b):
        for n in range(nb):
            np.add.at(out[bi, n], ids[bi, n], vals[bi, n])
    return out[:, :, :p]


@pytest.mark.parametrize("c", [1, 6, 16])
@pytest.mark.parametrize("kernel,dtype,fast", [
    ("E", "bfloat16", False), ("G", "float32", False), ("G", "float32", True),
    ("G", "bfloat16", False), ("G", "bfloat16", True)])
def test_scatter_plain_bit_equal_sequential_sum(kernel, dtype, fast, c):
    """Kernels E and G's plain versions over the plan are bit-equal to a
    sequential numpy f32 sum in edge order: E sums the bf16 rounding of
    its operand, G with ``fast`` the bf16 rounding of f32 input."""
    pos, pat, ev = _positions(c, 70 + c)
    p = pat.shape[2]
    tdt = getattr(torch, dtype)
    plan = BK.block_plan(_t(pos), p)
    x = _t(ev).to(tdt)
    rounded = kernel == "E" or fast
    terms = (x.to(torch.bfloat16) if rounded else x).float().numpy()
    if kernel == "E":
        got = IK.dot_scatter(plan, x, p)
        assert torch.equal(got, IK.dot_scatter_plain(plan, x, p))
    else:
        got = BK.block_scatter(plan, x, p, fast=fast)
    assert got.dtype == torch.float32 and got.shape == (B, 4, p, c)
    np.testing.assert_array_equal(got.numpy(), _sequential_sum(pos, terms, p))


def test_scatter_wrappers_refuse_an_unfit_plan():
    """A plan of another patch size, edge count or index dtype, or on
    another device, does not fit the scatter's vals: E and G raise."""
    pos, pat, ev = (_t(a) for a in _positions(4, 80))
    p = pat.shape[2]
    plan = BK.block_plan(pos, p)
    other_p = BK.block_plan(pos, p + 1)
    other_et = BK.block_plan(pos[:, :, :-1].contiguous(), p)
    for bad in (other_p, other_et, plan._replace(order=plan.order.long()),
                plan._replace(offsets=plan.offsets[:-1])):
        with pytest.raises(ValueError):
            BK.block_scatter(bad, ev, p)
        with pytest.raises(ValueError):
            IK.dot_scatter(bad, ev, p)
    with pytest.raises(ValueError):
        BK.block_scatter(plan, ev, p + 1)
    with pytest.raises(ValueError):
        BK.block_scatter(plan._replace(order=plan.order.to("meta")), ev, p)
    with pytest.raises(ValueError):
        BK.block_plan(pos.long(), p)


@pytest.mark.parametrize("core", CORES)
def test_plan_counts_equal_the_scatter_of_ones(core):
    """The in-degrees read off the plan (no kernel launch) equal the
    width-1 scatter of ones they replace, on the index route (self slot
    dropped, added back) and the block route, in bf16 and f32."""
    idx = _graph(seed=17)
    plan = tbl.block_index_plan(_t(idx), CELLS, W, core, drop_self_slot0=True)
    for dt in (torch.float32, torch.bfloat16):
        ones = torch.ones((B, N, K, 1), dtype=dt)
        want = tbl.masked_scatter_add(ones, plan, CELLS, W, core=core,
                                      self_slot0=True)[..., 0]
        got = tbl.masked_counts(plan, CELLS, W, core, True, dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    full = tbl.block_index_plan(_t(idx), CELLS, W, core)
    np.testing.assert_array_equal(
        tbl.plan_counts(full, CELLS, W, core).numpy(),
        Route.direct(_t(idx)).counts().numpy())


ROUTE_CONFIGS = {"direct": {}, "banded": {"neighbor_impl": "banded"},
                 "block": {"neighbor_impl": "block"}, "index": {"mask_dtype": "index"},
                 "int8": {"mask_dtype": "int8"}, "int4": {"mask_dtype": "int4"}}


# the masked index route keeps its case's old name, "masked"
@pytest.mark.parametrize("kind", list(ROUTE_CONFIGS),
                         ids=["masked" if k == "index" else k for k in ROUTE_CONFIGS])
def test_route_plan_is_the_routes_plan(kind):
    """The route registry._make_route builds once a forward holds its
    kind's one plan: the GraphPlan on the direct and banded routes (also
    its graph_plan), the BlockPlan of CORE blocks on the block route, the
    BlockPlan of patch positions (self slot dropped) on the index route
    and the int8 / packed int4 masks on theirs."""
    from nbody_tpu_torch import config as C
    from nbody_tpu_torch.models import registry
    from nbody_tpu_torch.ops.kernels.banded_kernels import graph_plan
    idx = _t(_graph())
    cfg = C.ModelConfig(k_neighbors=K, knn_window=W, **ROUTE_CONFIGS[kind])
    route = registry._make_route(cfg, CELLS, N, idx, torch.bfloat16)
    assert route.kind == kind and route.idx is idx
    if kind in ("direct", "banded"):
        want = graph_plan(idx)
    elif kind == "block":
        want = tbl.block_index_plan(idx, CELLS, W, tbl.CORE)
    elif kind == "index":
        want = tbl.block_index_plan(idx, CELLS, W, (4, 8, 8), drop_self_slot0=True)
    else:
        want = tbl.block_masks(idx, CELLS, W, core=(4, 8, 8), drop_self_slot0=True,
                               dtype=torch.int8 if kind == "int8" else "int4")
        assert torch.equal(route.plan, want) and route.graph_plan is None
        return
    got = route.plan
    assert type(got) is type(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert route.graph_plan is (got if kind in ("direct", "banded") else None)
