"""Port parity: the joint position+velocity path (shiftinv_vel,
``--velocity``), the masked index route (``--mask_dtype index``, kernels
D/E) and the ``--impl block`` route (kernels F/G), with the JAX parameters
loaded through params_from_jax.

Velocity features are bit-identical; f32 models and gradients match JAX to
rtol 1e-5 (gradients within the normalized bar of
tests/test_grad_parity.py:53-60); the bf16 index route meets JAX's bf16
index route at loss rtol 3e-2 and gradient cosine > 0.998.  The host
coverage search (scipy cKDTree) gives the per-row distance sums of JAX's
sklearn search.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.baseline_cpu import pbc_knn_host
from nbody_tpu.data import dataset as jdata
from nbody_tpu.models import shiftinv as js
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.ops import blocked as jbl
from nbody_tpu.ops import graph_features as jgf
from nbody_tpu.ops.knn import knn_periodic_lattice_batch as j_lattice
from nbody_tpu.physics.losses import loss_za as j_loss

from nbody_tpu_torch import config as C
from nbody_tpu_torch.cli import train as cli_train
from nbody_tpu_torch.data.dataset import Dataset, features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models import registry
from nbody_tpu_torch.models.base import ShiftInvVelParams, params_from_jax
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops import blocked as tbl
from nbody_tpu_torch.ops import graph_features as tgf
from nbody_tpu_torch.ops.route import Route
from nbody_tpu_torch.physics.losses import loss_za
from nbody_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CELLS = 8
K = 6
BOX = 4.0 * CELLS
VEL_CHANNELS = (9, 16, 8, 6)     # both layer branches: q >= C and q < C
CHANNELS = (3, 16, 8, 3)


def _batch(velocity, seed=0):
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=seed),
                          include_velocity=velocity)
    c = 9 if velocity else 6
    return np.ascontiguousarray(x[..., :c]), np.ascontiguousarray(x[..., c:])


def _pair(family, dtype, impl="masked", mask_dtype="auto", seed=3):
    """The JAX model with its params, and the port model holding them.
    The JAX reference of the direct route is neighbor_impl="banded" (on
    the CPU: XLA's native gather/scatter)."""
    channels = VEL_CHANNELS if family == "shiftinv_vel" else CHANNELS
    jimpl = "banded" if (impl, mask_dtype) == ("masked", "auto") else impl
    jcfg = JC.ModelConfig(family=family, channels=channels, k_neighbors=K,
                          dtype=dtype, knn_window=2, neighbor_impl=jimpl,
                          mask_dtype=mask_dtype, seed=seed)
    jmodel = j_build(jcfg, box=BOX)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = build_model(C.ModelConfig(
        family=family, channels=channels, k_neighbors=K, dtype=dtype,
        knn_window=2, neighbor_impl=impl, mask_dtype=mask_dtype), box=BOX,
        device="cpu")
    tmodel.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _flat_jax_grads(g):
    layers = g["layers"] if isinstance(g, dict) else g
    parts = [np.concatenate([np.asarray(p["W"]).ravel(), np.asarray(p["B"]).ravel()])
             for p in layers]
    if isinstance(g, dict):
        parts.append(np.asarray(g["T"]).ravel())
    return np.concatenate(parts).astype(np.float64)


def _flat_torch_grads(params):
    parts = [np.concatenate([w.grad.numpy().ravel(), b.grad.numpy().ravel()])
             for w, b in zip(params.W, params.B)]
    if isinstance(params, ShiftInvVelParams):
        parts.append(params.T.grad.numpy().ravel())
    return np.concatenate(parts).astype(np.float64)


def _loss_and_grads(family, dtype, impl="masked", mask_dtype="auto"):
    x_in, y = _batch(family == "shiftinv_vel")
    jmodel, jparams, tmodel = _pair(family, dtype, impl, mask_dtype)
    jval, jg = jax.jit(jax.value_and_grad(
        lambda p, x, t: j_loss(jmodel.apply(p, x), t)))(
            jparams, jnp.asarray(x_in), jnp.asarray(y))
    pred = tmodel(torch.from_numpy(x_in))
    assert pred.dtype == torch.float32 and pred.shape == y.shape
    tval = loss_za(pred, torch.from_numpy(y))
    tval.backward()
    return (float(jval), _flat_jax_grads(jg), float(tval.detach()),
            _flat_torch_grads(tmodel.params), tmodel)


def test_velocity_features_bit_identical():
    raw = synthetic_raw_cubes(12, CELLS, seed=2)
    x = features_from_raw(raw, include_velocity=True)
    assert x.shape == (12, CELLS ** 3, 15) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jdata.features_from_raw(raw, include_velocity=True))
    cfg = C.DataConfig(num_test=3, num_val=2, cells_per_side=CELLS,
                       include_velocity=True)
    ds = Dataset(cfg, raw=raw)
    jds = jdata.Dataset(JC.DataConfig(num_test=3, num_val=2, cells_per_side=CELLS,
                                      include_velocity=True), raw=raw)
    assert ds.num_input_channels == jds.num_input_channels == 9
    for got, want in ((ds.X_train, jds.X_train), (ds.X_val, jds.X_val),
                      (ds.X_test, jds.X_test)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route,dtype", [("direct", "float32"),
                                         ("direct", "bfloat16"),
                                         ("index", "bfloat16")])
def test_edge_features_with_nodes_match(route, dtype):
    x_in, _ = _batch(True, seed=4)
    pos = np.ascontiguousarray(x_in[..., :3] + BOX / 2.0 + x_in[..., 3:6])
    za, vel = x_in[..., 3:6], x_in[..., 6:9]
    idx = np.array(j_lattice(jnp.mod(jnp.asarray(pos) / BOX, 1.0), K,
                             cells=CELLS, window=2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jkw, troute = {}, Route.direct(torch.from_numpy(idx))
    if route == "index":
        core = tbl.MASKED_CORE
        jkw = dict(lattice=(CELLS, 2, core, True), masks=jbl.block_positions(
            jnp.asarray(idx), CELLS, 2, core, drop_self_slot0=True))
        troute = Route.masked("index", torch.from_numpy(idx), CELLS, 2, core)
    want = jgf.edge_features_with_nodes(
        jnp.asarray(pos).astype(jdt), jnp.asarray(idx), jnp.asarray(vel).astype(jdt),
        BOX, za_disp=jnp.asarray(za).astype(jdt), **jkw)
    got = tgf.edge_features_with_nodes(
        torch.from_numpy(pos).to(tdt), troute,
        torch.from_numpy(np.ascontiguousarray(vel)).to(tdt), BOX,
        za_disp=torch.from_numpy(np.ascontiguousarray(za)).to(tdt))
    assert got.dtype == tdt and got.shape == (2, CELLS ** 3, K, 9)
    want = np.asarray(want.astype(jnp.float32))
    # bf16: elementwise rounding differs between the frameworks; one bf16
    # ulp at |x| < 8 is 2^-5 (as tests/test_torch_neighbor_ops.py)
    atol = 1e-6 if dtype == "float32" else 2 ** -4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("impl", ["masked", "block"])
def test_vel_forward_matches_f32(impl):
    x_in, _ = _batch(True, seed=1)
    jmodel, jparams, tmodel = _pair("shiftinv_vel", "float32", impl=impl)
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x_in)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x_in)).numpy()
    assert got.shape == (2, CELLS ** 3, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    route = "direct" if impl == "masked" else "block"
    assert tmodel.impl_record["impl"] == route


@pytest.mark.parametrize("impl", ["masked", "block"])
def test_vel_loss_and_grads_match_f32(impl):
    jval, jg, tval, tg, _ = _loss_and_grads("shiftinv_vel", "float32", impl)
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    rms = float(np.sqrt(np.mean(jg ** 2)))
    scale = np.maximum(np.abs(jg), 0.05 * rms)
    np.testing.assert_allclose(tg / scale, jg / scale, rtol=0, atol=2e-3)


@pytest.mark.parametrize("family", ["shiftinv_vel", "shiftinv"])
def test_index_route_matches_jax_bf16(family):
    jval, jg, tval, tg, tmodel = _loss_and_grads(family, "bfloat16",
                                                 mask_dtype="index")
    assert tmodel.impl_record == {"impl": "masked", "core": [4, 8, 8],
                                  "mask_dtype": "index", "downgrade": None}
    assert np.isfinite(tval)
    np.testing.assert_allclose(tval, jval, rtol=3e-2)
    cos = float(jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    assert cos > 0.998, f"gradient cosine similarity {cos}"


def test_block_route_matches_jax_bf16():
    jval, jg, tval, tg, tmodel = _loss_and_grads("shiftinv_vel", "bfloat16",
                                                 impl="block")
    assert tmodel.impl_record["impl"] == "block"
    np.testing.assert_allclose(tval, jval, rtol=3e-2)
    cos = float(jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    assert cos > 0.998, f"gradient cosine similarity {cos}"


def test_params_from_jax_vel_tree():
    jparams = jax.tree_util.tree_map(np.asarray, js.init_shiftinv_vel_params(
        jax.random.PRNGKey(1), VEL_CHANNELS))
    p = params_from_jax(jparams)
    assert isinstance(p, ShiftInvVelParams) and len(p) == len(VEL_CHANNELS) - 1
    np.testing.assert_array_equal(p.T.detach().numpy(), jparams["T"])
    for w, b, jp in zip(p.W, p.B, jparams["layers"]):
        np.testing.assert_array_equal(w.detach().numpy(), jp["W"])
        np.testing.assert_array_equal(b.detach().numpy(), jp["B"])
    names = {n for n, _ in p.named_parameters()}
    assert "T" in names and len(names) == 2 * len(p) + 1
    model = build_model(C.ModelConfig(family="shiftinv_vel"), box=C.BOX_SIZE,
                        device="cpu")
    assert isinstance(model.params, ShiftInvVelParams)
    assert [tuple(w.shape) for w in model.params.W] == [
        (4, a, b) for a, b in zip(C.GRAPH_VEL_CHANNELS[:-1], C.GRAPH_VEL_CHANNELS[1:])]
    np.testing.assert_array_equal(model.params.T.detach().numpy(),
                                  np.full(2, C.SCALAR_INIT, np.float32))


def test_f32_index_downgrade_recorded():
    """Exact-f32 mode downgrades mask_dtype 'index' to the direct kernels
    (registry.py:243-249) and records it; the output is the direct
    route's, bit for bit."""
    x_in, _ = _batch(True, seed=6)
    _, _, tmodel = _pair("shiftinv_vel", "float32", mask_dtype="index")
    _, _, direct = _pair("shiftinv_vel", "float32")
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x_in))
        want = direct(torch.from_numpy(x_in))
    rec = tmodel.impl_record
    assert rec["impl"] == "direct" and rec["core"] is None
    assert "index" in rec["downgrade"] and "float32" in rec["downgrade"]
    assert direct.impl_record["downgrade"] is None
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("masked_core,cells,want", [
    (None, 8, [4, 8, 8]), ((2, 2, 2), 8, [2, 2, 2]), ((3, 3, 3), 8, [4, 8, 8]),
    (None, 12, [2, 2, 4]), (None, 6, [2, 2, 2])])
def test_index_core_choice(masked_core, cells, want):
    """The first candidate that tiles the cube: --masked_core, then
    (4,8,8), (4,4,8), (2,4,8), (2,2,4), (2,2,2) (registry.py:259-266)."""
    cfg = C.ModelConfig(mask_dtype="index", masked_core=masked_core,
                        k_neighbors=K, knn_window=2)
    idx = torch.zeros((1, cells ** 3, K), dtype=torch.int32)
    route = registry._make_route(cfg, cells, cells ** 3, idx, torch.bfloat16)
    masks = route.plan
    assert route.record()["core"] == want and route.kind == "index"
    assert (route.cells, route.window, route.core) == (cells, 2, tuple(want))
    assert masks.pos.shape == (1, cells ** 3 // int(np.prod(want)),
                               int(np.prod(want)) * (K - 1))
    assert masks.offsets.shape == (
        cells ** 3 // int(np.prod(want)) * tbl.patch_size(cells, 2, want) + 1,)


def test_coverage_host_search_matches_sklearn(monkeypatch):
    """Above EXACT_KNN_MAX_PARTICLES the exact side of the coverage check
    is the host cKDTree search: its per-row squared-distance sums equal
    those of JAX's sklearn ghost-padding search (pbc_knn_host, with the
    adaptive shell of registry.py:166-175) on a 16^3 cube."""
    cells, k = 16, 14
    x = features_from_raw(synthetic_raw_cubes(1, cells, seed=3))
    box = 4.0 * cells
    pos = x[..., :3] + box / 2.0 + x[..., 3:6]
    pos_norm = np.mod(pos / box, 1.0).astype(np.float32)
    thr = max(0.1, 4.0 * cells ** -1.0)
    want = registry.neighbor_sq_dist_sums(
        pos_norm, pbc_knn_host(pos_norm[0], k, boundary_threshold=thr)[None])
    got = registry.neighbor_sq_dist_sums(pos_norm,
                                         registry.exact_knn_host(pos_norm, k))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # coordinates that f32 mod rounded up to 1.0 wrap to 0.0
    edge = pos_norm.copy()
    edge[0, :5, 0] = 1.0
    assert registry.exact_knn_host(edge, k).shape == (1, cells ** 3, k)
    cfg = C.ModelConfig(k_neighbors=k, knn_window=2)
    x_in = torch.from_numpy(np.ascontiguousarray(x[..., :6]))
    device_exact = registry.coverage_violations(cfg, box, x_in)
    monkeypatch.setattr(registry, "EXACT_KNN_MAX_PARTICLES", 1000)
    assert registry.coverage_violations(cfg, box, x_in) == device_exact == 0


def test_trainer_vel_index_fit_evaluate():
    cfg = C.Config(
        data=C.DataConfig(data_dir="/nonexistent", num_test=2, num_val=1,
                          cells_per_side=CELLS, synthetic_num_samples=7,
                          include_velocity=True),
        model=C.ModelConfig(family="shiftinv_vel", channels=(9, 8, 6),
                            k_neighbors=K, knn_window=2, dtype="bfloat16",
                            mask_dtype="index", seed=4),
        train=C.TrainConfig(num_iters=2, batch_size=2, learn_rate=1e-3,
                            checkpoint_every=1))
    trainer = Trainer(cfg, "cpu")
    assert np.isfinite(trainer.fit(verbose=False))
    routes = [r["effective_neighbor_impl"] for r in trainer.metrics_log
              if "effective_neighbor_impl" in r]
    assert routes == [{"impl": "masked", "core": [4, 8, 8],
                       "mask_dtype": "index", "downgrade": None}]
    errors, preds = trainer.evaluate(verbose=False)
    assert preds.shape == (2, 2, CELLS ** 3, 6) and np.isfinite(preds).all()
    np.testing.assert_array_equal(preds[0], trainer.dataset.X_test[:2, :, 9:])
    assert np.isfinite(errors).all()
    with pytest.raises(ValueError):
        Trainer(C.Config(cfg.data, C.ModelConfig(channels=(3, 8, 3)), cfg.train),
                "cpu", dataset=trainer.dataset)


def test_config_velocity_and_route_flags():
    args = C.build_parser().parse_args(
        ["--velocity", "--mask_dtype", "index", "--masked_core", "8", "8", "8",
         "--dtype", "bfloat16", "--cells", "64", "-b", "1"])
    cfg = C.config_from_args(args)
    assert cfg.model.family == "shiftinv_vel" and cfg.data.include_velocity
    assert (cfg.model.neighbor_impl, cfg.model.mask_dtype,
            cfg.model.masked_core) == ("masked", "index", (8, 8, 8))
    cfg = C.config_from_args(C.build_parser().parse_args(["--impl", "block"]))
    assert cfg.model.neighbor_impl == "block" and cfg.model.family == "shiftinv"
    assert not cfg.data.include_velocity
    for flags in (["--velocity", "--model", "shiftinv"], ["--model", "shiftinv_vel"]):
        with pytest.raises(ValueError):
            C.config_from_args(C.build_parser().parse_args(flags))
    # int4 masks and --impl banded are ported (tests/test_torch_mask_route.py,
    # tests/test_torch_knn_methods.py); the parallel flags are not
    assert build_model(C.ModelConfig(mask_dtype="int4"),
                       device="cpu").cfg.mask_dtype == "int4"
    cfg = C.config_from_args(C.build_parser().parse_args(
        ["--velocity", "--impl", "banded"]))
    assert (cfg.model.family, cfg.model.neighbor_impl) == ("shiftinv_vel", "banded")
    with pytest.raises(NotImplementedError):
        C.config_from_args(C.build_parser().parse_args(
            ["--velocity", "--impl", "banded", "--data_axis", "2"]))


def test_cli_velocity_index_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path))
    rc = cli_train.main(["--platform", "cpu", "--velocity", "--mask_dtype",
                         "index", "--dtype", "bfloat16", "--cells", "8",
                         "-k", "6", "--knn_window", "2", "-c", "9", "8", "6",
                         "-i", "2", "-b", "2", "-t", "2", "--samples", "8",
                         "--synthetic"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "shiftinv_vel" in out and "Training finished!" in out
    assert "# Test Error" in out
    assert "'impl': 'masked', 'core': [4, 8, 8], 'mask_dtype': 'index'" in out
