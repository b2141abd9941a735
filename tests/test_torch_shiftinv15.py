"""Port parity: the 15-operator family (shiftinv15) against nbody_tpu's, on
the same numpy-seeded inputs, with the JAX parameters loaded through
params_from_jax.

- The block-structured symmetrized graph (idx, rev_pos, mask_b, deg) is
  bit-equal to build_block_sym_graph's id path and its lattice
  (offset-code) path.
- The cube-form layer (the reverse-edge lookup for the transpose) matches
  shift_inv_15op_layer in f32 (rtol 1e-5 / atol 1e-5), both branches of
  q < C and is_last on and off, and the flat edge-list oracle
  shift_inv_15op_layer_flat (rtol 1e-4 / atol 1e-5, JAX's own bar).
- The block-major layer on the index and int8 routes (plain versions of
  kernels D/E and H/I) matches _shift_inv_15op_layer_blocks with JAX's
  bf16 masks in bf16: within 2^-6 of the output's largest magnitude; in
  f32, with the index route's selections taken exactly in f32, the layer
  (both branches, is_last) and the whole block-major network match JAX's
  f32 einsum-mask forms to rtol 1e-5 / atol 1e-5.
- The whole model: f32 forward rtol 1e-5 / atol 1e-5 (outputs reach ~5
  after six layers; f32 sums in another order) and gradients within
  the normalized bar of tests/test_grad_parity.py:53-60 on the direct and
  block routes; bf16 loss rtol 3e-2 and gradient cosine > 0.998
  (tests/test_grad_parity.py:86-104) on the direct and index routes.
- fit = fit_scan, the train CLI, and one rollout hop.
- The fused edge epilogue (ops/kernels/edge_epilogue, its plain twins on
  the CPU): the layer bit-equal to the composition it replaced in f32
  and bf16, both transpose branches, is_last, relu fused and another
  activation after it, with gradients at f32 tolerance; gradcheck of the
  epilogue's and the transpose's autograd Functions in float64; the
  launch counters a train step moves.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.data.dataset import features_from_raw
from nbody_tpu.data.synthetic import synthetic_raw_cubes
from nbody_tpu.models import shiftinv15 as J15
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.ops import blocked as jblocked
from nbody_tpu.ops.knn import knn_periodic as j_knn
from nbody_tpu.ops.knn import knn_periodic_lattice_batch as j_lattice
from nbody_tpu.physics.losses import loss_za as j_loss
from nbody_tpu.train import rollout as j_rollout

from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.cli import train as cli_train
from nbody_tpu_torch.data.dataset import Dataset
from nbody_tpu_torch.models import shiftinv15 as T15
from nbody_tpu_torch.models.base import params_from_jax
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.banded import neighbor_gather, neighbor_scatter_add
from nbody_tpu_torch.ops.kernels import edge_epilogue as EE
from nbody_tpu_torch.physics.losses import loss_za
from nbody_tpu_torch.train.rollout import make_rollout, stack_params
from nbody_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CELLS = 8
K = 6
BOX = 4.0 * CELLS
CHANNELS = (3, 8, 6, 3)          # q >= C, then q < C twice


def _batch(seed=0):
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=seed))
    return np.ascontiguousarray(x[..., :6]), np.ascontiguousarray(x[..., 6:])


def _lattice_idx(seed=0):
    x_in, _ = _batch(seed)
    pos = x_in[..., :3] + BOX / 2.0 + x_in[..., 3:6]
    return np.array(j_lattice(jnp.mod(jnp.asarray(pos) / BOX, 1.0), K,
                              cells=CELLS, window=2))


# JAX's graph builds, compiled once for every test's shapes
_j_graph = jax.jit(J15.build_block_sym_graph)
_j_graph_lattice = jax.jit(lambda i: J15.build_block_sym_graph(
    i, lattice=(CELLS, 2)))


def _graphs(idx):
    """The JAX id-path graph and the port's, from the same idx."""
    jg = _j_graph(jnp.asarray(idx))
    tg = T15.build_block_sym_graph(torch.from_numpy(idx))
    return jg, tg


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_sym_graph_bit_equal_to_both_jax_paths():
    """8^3 lattice graph, K 6, window 2: the port's id path against JAX's id
    path and its lattice offset-code path; and an exact graph of 20 random
    points (not a lattice) against the id path."""
    idx = _lattice_idx(seed=1)
    jg, tg = _graphs(idx)
    jl = _j_graph_lattice(jnp.asarray(idx))
    for j in (jg, jl):
        np.testing.assert_array_equal(tg.rev_pos.numpy(), np.asarray(j.rev_pos))
        np.testing.assert_array_equal(tg.mask_b.numpy(), np.asarray(j.mask_b))
        np.testing.assert_array_equal(tg.deg.numpy(), np.asarray(j.deg))
    assert tg.rev_pos.dtype == tg.idx.dtype == torch.int32
    assert tg.mask_b.dtype == tg.deg.dtype == torch.float32
    assert 0 < float(tg.mask_b.mean()) < 1
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 1, (20, 3)).astype(np.float32)
    idx = np.array(j_knn(jnp.asarray(pos), 4))[None]
    jg, tg = _graphs(idx)
    for name in ("rev_pos", "mask_b", "deg"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))


def test_reverse_lookup_is_the_transpose():
    """The lookup's value at (n, k) is h_a[idx[n,k], rev_pos[n,k]]; on
    mutual edges applying it twice is the identity."""
    idx = _lattice_idx(seed=2)
    _, g = _graphs(idx)
    h = torch.randn(2, CELLS ** 3, K, 5, generator=torch.Generator().manual_seed(0))
    got = T15.reverse_edges(h, T15.reverse_lookup(g))
    b = torch.arange(2)[:, None, None]
    np.testing.assert_array_equal(got.numpy(),
                                  h[b, g.idx.long(), g.rev_pos.long()].numpy())
    mutual = (g.mask_b == 0)[..., None].expand_as(h)
    twice = T15.reverse_edges(got, T15.reverse_lookup(g))
    assert torch.equal(twice[mutual], h[mutual])


@pytest.mark.parametrize("c_in,q,is_last", [(5, 8, False), (8, 5, False),
                                            (5, 8, True), (8, 3, True)])
def test_cube_layer_matches_jax_f32(c_in, q, is_last):
    """Both transpose branches (q >= C: transpose then W; q < C: W first)."""
    idx = _lattice_idx(seed=3)
    jg, tg = _graphs(idx)
    rng = np.random.default_rng(c_in * 7 + q)
    mask = np.stack([np.ones_like(tg.mask_b.numpy()), tg.mask_b.numpy()], 1)
    h = (rng.normal(size=(2, 2, CELLS ** 3, K, c_in)) * mask[..., None]).astype(np.float32)
    params = {"W": (rng.normal(size=(15, c_in, q)) * 0.3).astype(np.float32),
              "B": rng.normal(size=(2, q)).astype(np.float32)}
    want = jax.jit(lambda hh, p: J15.shift_inv_15op_layer(hh, jg, p, is_last))(
        jnp.asarray(h), _jt(params))
    got = T15.shift_inv_15op_layer(torch.from_numpy(h), tg, _tt(params),
                                   is_last=is_last)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cube_layer_matches_flat_oracle():
    """20 random points, K 4 (as tests/test_shiftinv15.py:205-243): the
    port's block features and layer against the flat edge-list oracle."""
    rng = np.random.default_rng(6)
    n, k, box = 20, 4, 8.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    za = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    idx = np.array(j_knn(jnp.asarray(pos / box), k))
    params = {"W": (rng.normal(size=(15, 3, 5)) * 0.3).astype(np.float32),
              "B": rng.normal(size=(2, 5)).astype(np.float32)}
    g = J15.build_sym_graph(jnp.asarray(idx))
    feats = np.asarray(J15.sym_edge_features_za(
        jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(za), box))
    feats = feats * np.asarray(g.valid)[:, None]
    tg = T15.build_block_sym_graph(torch.from_numpy(idx)[None])
    fb = T15.block_edge_features_za(torch.from_numpy(pos)[None], tg,
                                    torch.from_numpy(za)[None], box)
    nk = n * k
    np.testing.assert_allclose(fb[0, 0].reshape(nk, 3).numpy(), feats[:nk], atol=1e-5)
    np.testing.assert_allclose(fb[0, 1].reshape(nk, 3).numpy(), feats[nk:], atol=1e-5)
    for is_last in (False, True):
        flat = np.asarray(jax.jit(lambda f, gg, p: J15.shift_inv_15op_layer_flat(
            f, gg, p, is_last=is_last))(
                jnp.asarray(feats)[None],
                jax.tree_util.tree_map(lambda x: x[None], g), _jt(params)))[0]
        got = T15.shift_inv_15op_layer(fb, tg, _tt(params), is_last=is_last)[0].numpy()
        if is_last:
            np.testing.assert_allclose(got, flat, rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_allclose(got[0].reshape(nk, -1), flat[:nk],
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got[1].reshape(nk, -1), flat[nk:],
                                       rtol=1e-4, atol=1e-5)


BLOCK_CORE, BLOCK_R = (4, 8, 8), 4 * 8 * 8   # two blocks of an 8^3 cube


def _exact_f32_selection(monkeypatch):
    """The masked routes' selections without their bf16 cast: kernels D/E's
    plain gather and segment sum in the values' own dtype (f32), so that
    the block-major layer's algebra can be held to JAX's f32 einsum masks
    at float tolerance."""
    from nbody_tpu_torch.ops.kernels import block_kernels as BK
    monkeypatch.setattr(blocked, "_mask_contract_gather",
                        lambda plan, patches: BK.select_gather_plain(plan.pos, patches))
    monkeypatch.setattr(blocked, "_mask_contract_scatter",
                        lambda plan, edges, p: BK.plan_scatter_plain(plan, edges, p))


def _block_layer_pair(route, c_in, q, dtype):
    """One block-major layer on the same inputs: JAX's (its einsum masks in
    `dtype`) and the port's (the index route's plan or int8 masks, and the
    block-major reverse-edge lookup), both as float32 numpy."""
    idx = _lattice_idx(seed=4)
    jg, tg = _graphs(idx)
    b, n = 2, CELLS ** 3
    lat = (CELLS, 2, BLOCK_CORE, True)
    rng = np.random.default_rng(q)
    mb = tg.mask_b.numpy()
    mask = np.stack([np.ones_like(mb), mb], 1)
    h = (rng.normal(size=(b, 2, n, K, c_in)) * mask[..., None]).astype(np.float32)
    params = {"W": (rng.normal(size=(15, c_in, q)) * 0.3).astype(np.float32),
              "B": rng.normal(size=(2, q)).astype(np.float32)}
    is_last = q == 3
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    j_hB = jblocked.cube_to_blocks(jnp.asarray(h, jdt).reshape(b * 2, n, K * c_in),
                                   CELLS, BLOCK_CORE).reshape(b, 2, -1, BLOCK_R, K, c_in)
    sel = jax.nn.one_hot(jg.rev_pos, K, dtype=jdt).reshape(b, n, K * K)
    selB = jblocked.cube_to_blocks(sel, CELLS, BLOCK_CORE).reshape(b, -1, BLOCK_R, K, K)
    j_mbB = jblocked.cube_to_blocks(jg.mask_b.astype(jdt), CELLS, BLOCK_CORE)
    masks = jblocked.block_masks(jnp.asarray(idx), CELLS, 2, dtype=jdt,
                                 core=BLOCK_CORE, drop_self_slot0=True)
    want = jax.jit(lambda hh, p: J15._shift_inv_15op_layer_blocks(
        hh, p, masks, lat, selB, j_mbB, jg.deg, jnp.sum(jg.deg, -1), is_last))(
            j_hB, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params))
    t_idx = torch.from_numpy(idx)
    t_masks = (blocked.block_index_plan(t_idx, CELLS, 2, BLOCK_CORE, drop_self_slot0=True)
               if route == "index" else
               blocked.block_masks(t_idx, CELLS, 2, torch.int8, BLOCK_CORE, True))
    hB = blocked.edges_cube_to_blocks(
        torch.from_numpy(h).to(tdt).reshape(b * 2, n, K, c_in),
        CELLS, BLOCK_CORE).reshape(b, 2, -1, BLOCK_R, K, c_in)
    mbB = blocked.cube_to_blocks(tg.mask_b.to(tdt), CELLS, BLOCK_CORE)
    got = T15._shift_inv_15op_layer_blocks(
        hB, {k: v.to(tdt) for k, v in _tt(params).items()}, t_masks, lat, mbB,
        tg.deg, tg.deg.sum(-1), T15.reverse_lookup(tg, CELLS, BLOCK_CORE), is_last)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("route,c_in,q", [("index", 8, 6), ("int8", 6, 8),
                                          ("index", 6, 3)])
def test_block_layer_matches_jax_bf16(route, c_in, q):
    """The block-major layer on the index and int8 routes (the plain
    versions of D/E and H/I) and the block-major reverse-edge lookup
    against JAX's bf16 einsum masks and its K*C-wide transpose ride."""
    got, want = _block_layer_pair(route, c_in, q, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())


@pytest.mark.parametrize("c_in,q", [(8, 6), (6, 8), (6, 3)])
def test_block_layer_matches_jax_f32(c_in, q, monkeypatch):
    """The same layer in f32, both transpose branches and is_last, with
    the index route's selections taken exactly in f32: the layer's algebra
    to float tolerance (rtol 1e-5 / atol 1e-5)."""
    _exact_f32_selection(monkeypatch)
    got, want = _block_layer_pair("index", c_in, q, "float32")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_block_network_matches_jax_f32(monkeypatch):
    """The whole block-major network (features, channels 3-8-3: both
    transpose branches, the lookup over block-major ids) in f32 against
    shiftinv15_model on JAX's f32 einsum masks, selections exact as
    above: rtol 1e-5 / atol 1e-5."""
    _exact_f32_selection(monkeypatch)
    x_in, _ = _batch(seed=5)
    pos = (x_in[..., :3] + BOX / 2.0 + x_in[..., 3:6]).astype(np.float32)
    za = np.ascontiguousarray(x_in[..., 3:6])
    idx = _lattice_idx(seed=5)
    lat = (CELLS, 2, BLOCK_CORE, True)
    params = J15.init_shiftinv15_params(jax.random.PRNGKey(1), (3, 8, 3))
    jmasks = jblocked.block_masks(jnp.asarray(idx), CELLS, 2, dtype=jnp.float32,
                                  core=BLOCK_CORE, drop_self_slot0=True)
    want = np.asarray(jax.jit(lambda p: J15.shiftinv15_model(
        p, jnp.asarray(pos), jnp.asarray(za), jnp.asarray(idx), BOX,
        lattice=lat, masks=jmasks))(params))
    plan = blocked.block_index_plan(torch.from_numpy(idx), CELLS, 2, BLOCK_CORE,
                                    drop_self_slot0=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params)).layers()
    got = T15.shiftinv15_model(tparams, torch.from_numpy(pos), torch.from_numpy(za),
                               torch.from_numpy(idx), BOX, lattice=lat, masks=plan)
    assert got.shape == want.shape == (2, CELLS ** 3, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def _pair(dtype, impl="masked", mask_dtype="auto", seed=3, channels=CHANNELS):
    """The JAX model on the matching route with its params, and the port
    model holding them (JAX's direct route is neighbor_impl "banded")."""
    j_impl = {"masked": "masked" if mask_dtype != "auto" else "banded",
              "block": "block"}[impl]
    jmodel = j_build(JC.ModelConfig(
        family="shiftinv15", channels=channels, k_neighbors=K, dtype=dtype,
        knn_window=2, neighbor_impl=j_impl, seed=seed), box=BOX)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = build_model(C.ModelConfig(
        family="shiftinv15", channels=channels, k_neighbors=K, dtype=dtype,
        knn_window=2, neighbor_impl=impl, mask_dtype=mask_dtype), box=BOX,
        device="cpu")
    tmodel.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _flat(grads):
    return np.concatenate([np.concatenate([np.asarray(w).ravel(),
                                           np.asarray(b).ravel()])
                           for w, b in grads]).astype(np.float64)


def _loss_and_grads(dtype, impl="masked", mask_dtype="auto", channels=CHANNELS):
    x_in, y = _batch()
    jmodel, jparams, tmodel = _pair(dtype, impl, mask_dtype, channels=channels)
    def j_loss_pred(p, x, t):
        pred = jmodel.apply(p, x)
        return j_loss(pred, t), pred

    (jval, jpred), jg = jax.jit(jax.value_and_grad(j_loss_pred, has_aux=True))(
        jparams, jnp.asarray(x_in), jnp.asarray(y))
    pred = tmodel(torch.from_numpy(x_in))
    tval = loss_za(pred, torch.from_numpy(y))
    tval.backward()
    return (np.asarray(jpred), float(jval), _flat((p["W"], p["B"]) for p in jg),
            pred.detach().numpy(), float(tval.detach()),
            _flat((w.grad, b.grad) for w, b in zip(tmodel.params.W, tmodel.params.B)),
            tmodel.impl_record)


@pytest.mark.parametrize("impl", ["masked", "block"])
def test_model_matches_jax_f32(impl):
    jpred, jval, jg, pred, tval, tg, rec = _loss_and_grads("float32", impl)
    assert rec["impl"] == {"masked": "direct", "block": "block"}[impl]
    assert pred.shape == (2, CELLS ** 3, 3)
    np.testing.assert_allclose(pred, jpred, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    rms = float(np.sqrt(np.mean(jg ** 2)))
    scale = np.maximum(np.abs(jg), 0.05 * rms)
    np.testing.assert_allclose(tg / scale, jg / scale, rtol=0, atol=2e-3)


@pytest.mark.parametrize("mask_dtype", ["auto", "index"])
def test_model_matches_jax_bf16(mask_dtype):
    """The direct route (cube form) and the index route (block-major form,
    core (8, 8, 8) as JAX chooses for this family) against JAX's bf16
    direct and masked routes; channels 3-8-3 (both transpose branches)."""
    _, jval, jg, _, tval, tg, rec = _loss_and_grads("bfloat16", "masked",
                                                     mask_dtype, (3, 8, 3))
    if mask_dtype == "index":
        assert rec["impl"] == "masked" and rec["core"] == [8, 8, 8]
    assert np.isfinite(tval)
    np.testing.assert_allclose(tval, jval, rtol=3e-2)
    cos = float(jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    assert cos > 0.998, f"gradient cosine similarity {cos}"


def _train_cfg(**model):
    return C.Config(
        data=C.DataConfig(data_dir=os.path.join(os.sep, "nonexistent"),
                          num_test=2, num_val=1, cells_per_side=CELLS,
                          synthetic_num_samples=10),
        model=C.ModelConfig(family="shiftinv15", channels=(3, 8, 3),
                            k_neighbors=K, knn_window=2, seed=4, **model),
        train=C.TrainConfig(num_iters=6, batch_size=2, learn_rate=1e-3,
                            checkpoint_every=3))


def test_fit_scan_equals_fit():
    """Two chunks of 3 steps: the losses and parameters bit-equal to fit's."""
    cfg = _train_cfg()
    ds = Dataset(cfg.data)
    eager, scan = Trainer(cfg, "cpu", dataset=ds), Trainer(cfg, "cpu", dataset=ds)
    eager.fit(verbose=False)
    scan.fit_scan(scan_chunk=3, verbose=False)
    assert eager.train_error_history == scan.train_error_history
    assert len(scan.train_error_history) == 2 and scan.step == 6
    for a, b in zip(eager.model.parameters(), scan.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags", [
    ["--model", "shiftinv15"], ["--model", "shiftinv15", "--remat"],
    ["--impl", "banded"], ["--remat", "--impl", "block"]])
def test_cli_train_runs(flags, capsys, tmp_path, monkeypatch):
    """cli.train on the CPU with each ported flag writes its run."""
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path))
    rc = cli_train.main(flags + [
        "--platform", "cpu", "--cells", "8", "-k", "6", "--knn_window", "2",
        "-c", "3", "8", "3", "--synthetic", "--samples", "8", "-t", "2",
        "-b", "2", "-i", "2", "-n", "run"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Training finished!" in out and "# Test Error" in out
    root = tmp_path / "ZA-FPM_0_run"
    assert (root / "Session" / "chkpt-2.pt").exists()
    assert (root / "Results" / "X_0_prediction.npy").exists()
    impl = "banded" if "banded" in flags else ("block" if "block" in flags else "direct")
    assert f"'impl': '{impl}'" in out


def test_rollout_hop_matches_jax():
    """One hop of the chain (make_rollout) with a 15-op model: the
    trajectory against JAX's make_rollout, rtol 1e-4 / atol 1e-5."""
    jmodel, jparams, tmodel = _pair("float32")
    x_in, _ = _batch(seed=9)
    _, jtraj = j_rollout.make_rollout(jmodel)(
        j_rollout.stack_params([jparams]), jnp.asarray(x_in))
    _, traj = make_rollout(tmodel)(stack_params([dict(tmodel.named_parameters())]),
                                   torch.from_numpy(x_in))
    assert traj.shape == (1, 2, CELLS ** 3, 3)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-4,
                               atol=1e-5)


def _composed_layer(h, g, layer_params, is_last):
    """The cube-form layer as it was composed before its edge epilogue was
    fused (one PyTorch pass an operation): the fused layer's oracle."""
    w, bias, dt = layer_params["W"], layer_params["B"], h.dtype
    lookup = T15.reverse_lookup(g)

    def mm(x, wi):
        return T15._mm(x, wi, dt)

    def transpose(x):
        xa, mbx = x[:, 0], g.mask_b[..., None]
        ta = T15.reverse_edges(xa, lookup) * (1.0 - mbx) + x[:, 1] * mbx
        return torch.stack([ta, xa * mbx], dim=1)

    c_in = h.shape[-1]
    mb = g.mask_b[..., None]
    h_d = h[:, 0, :, 0, :]
    hb_m = h[:, 1] * mb
    s2 = neighbor_scatter_add(torch.cat([h[:, 0].to(hb_m.dtype), hb_m], dim=-1),
                              g.idx)
    sum_a = torch.sum(h[:, 0], dim=2)
    h_r = (s2[..., :c_in] + torch.sum(hb_m, dim=2)) / g.deg[..., None]
    h_c = (sum_a + s2[..., c_in:]) / g.deg[..., None]
    live = torch.sum(g.deg, dim=-1)
    h_a = (torch.sum(h[:, 0], dim=(1, 2)) + torch.sum(hb_m, dim=(1, 2))) / live[:, None]
    h_p = torch.mean(h_d, dim=1)
    out = mm(h, w[0])
    x_col = mm(h_r, w[3]) + mm(h_c, w[7]) + mm(h_d, w[13])
    x_row = mm(h_r, w[4]) + mm(h_c, w[6]) + mm(h_d, w[14])
    if w.shape[-1] < w.shape[-2]:
        out = out + transpose(mm(h, w[1]))
    else:
        out = out + mm(transpose(h), w[1])
    g_col = neighbor_gather(x_col, g.idx)
    out = out + torch.stack([g_col, x_col[:, :, None, :].expand_as(g_col)], 1)
    g_row = neighbor_gather(x_row, g.idx)
    out = out + torch.stack([x_row[:, :, None, :].expand_as(g_row), g_row], 1)
    a9 = mm(h_a, w[9])[:, None, None, None, :]
    p11 = mm(h_p, w[11])[:, None, None, None, :]
    b1 = bias[1]
    diag = out[:, 0, :, 0, :]
    diag = diag + mm(h_d, w[2])
    diag = diag + mm(h_r, w[5])
    diag = diag + mm(h_c, w[8])
    diag = diag + a9[:, 0, 0]
    diag = diag + mm(h_a, w[10])[:, None, :]
    diag = diag + p11[:, 0, 0]
    diag = diag + mm(h_p, w[12])[:, None, :]
    diag = diag + bias[0] + b1
    sel = torch.zeros(out.shape[1:-1] + (1,), dtype=torch.bool)
    sel[0, :, 0, :] = True
    out = torch.where(sel, diag[:, None, :, None, :], out + a9 + p11 + b1)
    out = out * torch.stack([torch.ones_like(g.mask_b), g.mask_b], dim=1)[..., None]
    if is_last:
        sums = torch.sum(out[:, 0], dim=2) + neighbor_scatter_add(
            out[:, 1] * g.mask_b[..., None], g.idx)
        return sums / g.deg[..., None]
    return out


@pytest.mark.parametrize("c_in,q,is_last,activation,dtype", [
    (5, 8, False, torch.relu, "float32"),     # q >= C: transpose, then W
    (8, 5, False, torch.relu, "float32"),     # q < C: W, then transpose
    (5, 8, False, torch.tanh, "float32"),          # not relu: applied after
    (8, 5, False, torch.tanh, "float32"),
    (5, 8, True, torch.relu, "float32"),      # the last layer: row pool
    (8, 3, True, torch.relu, "float32"),
    (3, 8, False, torch.relu, "bfloat16"),    # layer 0 of a bf16 network
])
def test_fused_layer_equals_composition(c_in, q, is_last, activation, dtype):
    """The layer with its fused edge epilogue against the composition it
    replaced (activation after it): the forward bit-equal, the gradients
    of h, W and B within f32 tolerance (the fused backward sums in
    another order)."""
    idx = _lattice_idx(seed=7)
    _, g = _graphs(idx)
    rng = np.random.default_rng(c_in * 11 + q)
    mask = np.stack([np.ones_like(g.mask_b.numpy()), g.mask_b.numpy()], 1)
    h0 = torch.from_numpy(
        (rng.normal(size=(2, 2, CELLS ** 3, K, c_in)) * mask[..., None]).astype(np.float32))
    p0 = {"W": torch.from_numpy((rng.normal(size=(15, c_in, q)) * 0.3).astype(np.float32)),
          "B": torch.from_numpy(rng.normal(size=(2, q)).astype(np.float32))}
    r = torch.from_numpy(rng.normal(size=(2, CELLS ** 3, q) if is_last
                                    else (2, 2, CELLS ** 3, K, q)).astype(np.float32))
    dt = getattr(torch, dtype)
    results = []
    for fused in (True, False):
        h = h0.to(dt).requires_grad_()
        params = {k: v.clone().requires_grad_() for k, v in p0.items()}
        layer = {k: v.to(dt) for k, v in params.items()}
        if fused:
            out = T15.shift_inv_15op_layer(h, g, layer, is_last=is_last,
                                           activation=activation)
        else:
            out = _composed_layer(h, g, layer, is_last)
            out = out if is_last else activation(out)
        (out.float() * r).sum().backward()
        results.append((out.detach(), h.grad, params["W"].grad, params["B"].grad))
    (out, *grads), (want, *want_grads) = results
    assert out.dtype == want.dtype and out.shape == want.shape
    assert torch.equal(out, want)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got_g, want_g in zip(grads, want_grads):
        scale = float(want_g.abs().max())
        np.testing.assert_allclose(got_g.float().numpy(), want_g.float().numpy(),
                                   rtol=tol, atol=tol * scale)


def _epilogue_inputs(select, seed, b=2, n=6, k=3, q=2, c=None):
    """float64 operands of the epilogue at a tiny cube, and a 0/1 mask."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    mask_b = (torch.rand(b, n, k, generator=gen) < 0.4).to(torch.float64)
    mask_b[..., 0] = 0.0
    return mask_b, (rnd(b, 2, n, k, q), rnd(b, 2, n, k, q),
                    rnd(b, n, k, q) if select else None,
                    rnd(b, n, k, q), rnd(b, n, k, q), rnd(b, n, q), rnd(b, n, q),
                    rnd(b, n, q), rnd(b, n, q), rnd(b, n, q), rnd(b, q), rnd(b, q),
                    rnd(b, q), rnd(b, q), rnd(q), rnd(q))


@pytest.mark.parametrize("select,relu", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_epilogue_function_gradcheck(select, relu):
    """gradcheck of the epilogue's autograd Function (its plain backward
    twin) in float64, both transpose branches, with and without relu."""
    mask_b, terms = _epilogue_inputs(select, seed=3 + 2 * select + relu)
    live = [x for x in terms if x is not None]

    def f(*xs):
        it = iter(xs)
        full = [None if x is None else next(it) for x in terms]
        return EE.EdgeEpilogue.apply(relu, mask_b, *full)

    assert torch.autograd.gradcheck(f, live, eps=1e-6, atol=1e-7)


def test_transpose_function_gradcheck():
    """gradcheck of the edge transpose's autograd Function in float64."""
    mask_b, terms = _epilogue_inputs(False, seed=11)
    h, rev = terms[0], terms[3]
    assert torch.autograd.gradcheck(
        lambda a, r: EE.EdgeTranspose.apply(a, r, mask_b), (h, rev),
        eps=1e-6, atol=1e-7)


def _operands(q=8, dt=torch.float32, mask_dt=torch.float32, odd=None,
              bias_dt=torch.bfloat16):
    """(mask_b, tensors, biases) of the kernels' check at width q, one
    tensor of `odd` dtype where given."""
    mask_b = torch.ones(1, 2, 3, dtype=mask_dt)
    tensors = [torch.zeros(1, 2, 2, 3, q, dtype=dt), torch.zeros(1, 2, q, dtype=dt)]
    if odd is not None:
        tensors.append(torch.zeros(1, q, dtype=odd))
    return mask_b, tensors, [torch.zeros(q, dtype=bias_dt)] * 2


def test_kernel_check_takes_the_model_operands():
    """The kernels' check passes the operands the port hands them: f32 or
    bf16 tensors of one dtype with f32 or bf16 biases, an f32 mask."""
    for dt in (torch.float32, torch.bfloat16):
        for bias_dt in (torch.float32, torch.bfloat16):
            mask_b, tensors, biases = _operands(64, dt, bias_dt=bias_dt)
            EE._check("edge_epilogue", 64, mask_b, tensors, biases)


@pytest.mark.parametrize("kw,width,match", [
    ({"dt": torch.float64}, 8, "one dtype"),
    ({"odd": torch.bfloat16}, 8, "one dtype"),
    ({"mask_dt": torch.bfloat16}, 8, "float32 mask"),
    ({"bias_dt": torch.float16}, 8, "biases"),
    ({}, 257, "widths up to"),
])
def test_kernel_check_refuses(kw, width, match):
    """On a card the wrappers raise ValueError for operands their kernels
    do not take, as the port's other kernel wrappers do, and run no
    other path."""
    mask_b, tensors, biases = _operands(width, **kw)
    with pytest.raises(ValueError, match=match):
        EE._check("edge_epilogue", width, mask_b, tensors, biases)


def _count_wrappers(monkeypatch):
    """Count each call of the epilogue's and the transpose's wrappers as
    they count a kernel launch on the card (on the CPU they take their
    plain twins)."""
    for name in ("edge_epilogue_forward", "edge_epilogue_backward",
                 "edge_transpose_forward", "edge_transpose_backward"):
        def counted(*args, _orig=getattr(EE, name), _name=name):
            tracing.count(f"launch.{_name}")
            return _orig(*args)
        monkeypatch.setattr(EE, name, counted)


@pytest.mark.parametrize("channels,want", [
    ((3, 8, 6, 3), {"edge_epilogue_forward": 3, "edge_epilogue_backward": 3,
                    "edge_transpose_forward": 1}),
    ((3, 6, 8, 3), {"edge_epilogue_forward": 3, "edge_epilogue_backward": 3,
                    "edge_transpose_forward": 2, "edge_transpose_backward": 1}),
])
def test_train_step_launches_the_epilogue(channels, want, monkeypatch):
    """One eager train step on the direct route moves
    launch.edge_epilogue_forward and its backward once a layer, and the
    transpose's once a widening layer (its backward not in layer 0, whose
    input needs no gradient); the B and C calls are the layer's as
    before."""
    from nbody_tpu_torch.ops.kernels import banded_kernels as BK
    from nbody_tpu_torch.train.trainer import make_optimizer, make_train_step
    _count_wrappers(monkeypatch)
    calls = {"gather": 0, "scatter": 0}
    for attr, key in (("neighbor_gather", "gather"), ("neighbor_segment_sum", "scatter")):
        def counted(*args, _orig=getattr(BK, attr), _key=key):
            calls[_key] += 1
            return _orig(*args)
        monkeypatch.setattr(BK, attr, counted)
    _, _, tmodel = _pair("bfloat16", channels=channels)
    step = make_train_step(tmodel, make_optimizer(tmodel, 1e-3))
    x_in, y = _batch()
    before = tracing.counters()
    step(torch.from_numpy(x_in), torch.from_numpy(y))
    moved = {k[len("launch."):]: v for k, v in tracing.delta(before).items()
             if k.startswith("launch.")}
    assert moved == want
    layers = len(channels) - 1
    # B: the id gather, the features', 3 a layer forward, a pool-scatter
    # gradient a layer after the first and the row pool's; C: the degree,
    # a pool scatter a layer, the row pool, 2 broadcast gradients a layer,
    # a lookup gradient a layer after the first
    assert calls == {"gather": 2 + 3 * layers + (layers - 1) + 1,
                     "scatter": 1 + layers + 1 + 2 * layers + (layers - 1)}
