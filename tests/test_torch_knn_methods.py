"""Port parity: the kNN methods and the band (ModelConfig.knn_method "lattice"
| "banded" | "exact", ``band``), non-cube point sets and ``--impl banded``,
against the JAX package on the same numpy-seeded inputs.

The banded search's ids are bit-equal to JAX's, in the same order (ties by
slab position), for several N and bands, including bands that take the
exact fallback; default_band and band_violations equal JAX's;
coverage_violations agrees with JAX for every method; a non-cube forward
(8^3 - 1 points, exact search) matches JAX's in f32 to rtol 1e-5 / atol
1e-6; and neighbor_impl "banded" is bit-equal to the direct route, since
both run the direct kernels' exact semantics.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.data.dataset import features_from_raw
from nbody_tpu.data.synthetic import synthetic_raw_cubes
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.models.registry import coverage_violations as j_coverage
from nbody_tpu.ops import banded as jbanded
from nbody_tpu.ops import knn as jknn

from nbody_tpu_torch import config as C
from nbody_tpu_torch.models.base import params_from_jax
from nbody_tpu_torch.models.registry import build_model, coverage_violations
from nbody_tpu_torch.ops import banded as tbanded
from nbody_tpu_torch.ops import knn as tknn

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

CELLS = 8
BOX = 4.0 * CELLS


def _x_in(seed=0, za_scale=1.0):
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=seed))
    x = np.ascontiguousarray(x[..., :6]).copy()
    x[..., 3:6] *= za_scale
    return x


def _unit(x_in):
    pos = x_in[..., :3] + BOX / 2.0 + x_in[..., 3:6]
    return np.mod(pos / BOX, 1.0).astype(np.float32)


@pytest.mark.parametrize("case,band", [
    ("cube", 128), ("cube", 256), ("cube", 500),   # chunks 256, 256, 8
    ("grid", 256),                                 # undisplaced: every distance ties
    ("cube", 512), ("cube", 700),                  # band >= N: the exact fallback
    ("random343", 100), ("random300", 64)])        # chunks 1 and 4
def test_banded_knn_bit_equal(case, band):
    """Ids bit-equal to knn_periodic(band=), slot for slot."""
    rng = np.random.default_rng(band)
    if case.startswith("random"):
        pos = rng.uniform(0, 1, (2, int(case[6:]), 3)).astype(np.float32)
    else:
        pos = _unit(_x_in(seed=band, za_scale=0.0 if case == "grid" else 1.0))
    n = pos.shape[1]
    assert tknn._banded_chunk(n, band) == jknn._banded_chunk(n, band)
    want = np.asarray(jknn.knn_periodic_batch(jnp.asarray(pos), 6, band=band))
    got = tknn.knn_periodic_batch(torch.from_numpy(pos), 6, band=band)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tknn.knn_periodic(torch.from_numpy(pos[0]), 6, band=band).numpy(),
        want[0])


def test_banded_chunk_none_falls_back():
    """No banded layout (band >= N) -> the exact search, as ops/knn.py:76."""
    assert tknn._banded_chunk(512, 512) is None is jknn._banded_chunk(512, 512)
    pos = _unit(_x_in(seed=3))
    exact = tknn.knn_periodic_batch(torch.from_numpy(pos), 6)
    np.testing.assert_array_equal(
        tknn.knn_periodic_batch(torch.from_numpy(pos), 6, band=600).numpy(),
        exact.numpy())


@pytest.mark.parametrize("cells", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_default_band_matches_jax(cells, window):
    assert tbanded.default_band(cells, window) == jbanded.default_band(cells, window)


@pytest.mark.parametrize("band", [16, 64, 200, 512])
def test_band_violations_match_jax(band):
    """Exact 8^3 graphs: narrow bands drop links, N does not."""
    idx = np.array(jknn.knn_periodic_batch(jnp.asarray(_unit(_x_in(seed=1))), 6))
    want = int(jbanded.band_violations(jnp.asarray(idx), band))
    got = tbanded.band_violations(torch.from_numpy(idx), band)
    assert int(got) == want
    assert (want > 0) == (band < 512)


@pytest.mark.parametrize("method,band,za_scale,want_zero", [
    ("banded", "auto", 1.0, True), ("banded", 64, 1.0, False),
    ("banded", 256, 1.0, True), ("banded", None, 1.0, True),
    ("exact", "auto", 6.0, True), ("lattice", "auto", 6.0, False)])
def test_coverage_violations_per_method(method, band, za_scale, want_zero):
    """Counts equal JAX's: the band's violations of the exact graph for
    "banded", 0 for "exact", the lattice comparison for "lattice"."""
    x_in = _x_in(seed=5, za_scale=za_scale)
    kw = dict(k_neighbors=6, knn_window=1, knn_method=method, band=band)
    got = coverage_violations(C.ModelConfig(**kw), BOX, torch.from_numpy(x_in))
    want = j_coverage(JC.ModelConfig(family="shiftinv", **kw), BOX, x_in)
    assert got == want
    assert (got == 0) == want_zero


def test_coverage_violations_non_cube():
    """The lattice method on a point set that is not a full cube searches
    exactly: no band is assumed, so nothing can be dropped (registry.py:
    204-206); the port no longer refuses it."""
    x_in = _x_in(seed=5)[:, :-1]
    cfg = dict(k_neighbors=6, knn_window=2)
    got = coverage_violations(C.ModelConfig(**cfg), BOX, torch.from_numpy(x_in))
    assert got == j_coverage(JC.ModelConfig(family="shiftinv", **cfg), BOX,
                             x_in) == 0


@pytest.mark.parametrize("method,band", [("lattice", "auto"), ("banded", 256),
                                         ("banded", "auto"), ("exact", "auto")])
def test_knn_fn_dispatch_matches_jax(method, band):
    """The model's in-step search per knn_method, ids bit-equal to JAX's
    knn_fn (_make_knn) on the same input."""
    x_in = _x_in(seed=2)
    kw = dict(channels=(3, 8, 3), k_neighbors=6, knn_window=2,
              knn_method=method, band=band)
    jmodel = j_build(JC.ModelConfig(family="shiftinv", **kw), box=BOX)
    tmodel = build_model(C.ModelConfig(**kw), box=BOX, device="cpu")
    np.testing.assert_array_equal(
        tmodel.knn_fn(torch.from_numpy(x_in)).numpy(),
        np.asarray(jmodel.knn_fn(jnp.asarray(x_in))))


def _jax_pair(x_in, **kw):
    """JAX forward (its direct route) and the port model holding its params."""
    jmodel = j_build(JC.ModelConfig(family="shiftinv", channels=(3, 8, 16, 3),
                                    k_neighbors=6, knn_window=2,
                                    neighbor_impl="banded", seed=4, **kw),
                     box=BOX)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x_in)))
    tmodel = build_model(C.ModelConfig(channels=(3, 8, 16, 3), k_neighbors=6,
                                       knn_window=2, **kw), box=BOX, device="cpu")
    tmodel.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return want, tmodel


@pytest.mark.parametrize("method", ["lattice", "exact"])
def test_non_cube_forward_matches_jax(method):
    """N = 8^3 - 1 points: the exact search, an exact gather of the
    positions, the direct kernels; f32 to rtol 1e-5 / atol 1e-6."""
    x_in = _x_in(seed=6)[:, :-1].copy()
    want, tmodel = _jax_pair(x_in, knn_method=method)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x_in))
    assert got.shape == (2, CELLS ** 3 - 1, 3)
    assert tmodel.impl_record["impl"] == "direct"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_banded_knn_method_forward_matches_jax():
    """knn_method "banded" with an explicit band on the cube."""
    x_in = _x_in(seed=7)
    want, tmodel = _jax_pair(x_in, knn_method="banded", band=256)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x_in))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family,dtype", [("shiftinv", "float32"),
                                          ("shiftinv", "bfloat16"),
                                          ("shiftinv15", "float32")])
def test_impl_banded_bit_equal_to_direct(family, dtype):
    """--impl banded runs the direct kernels: on a lattice cube the band is
    never binding, so forward and gradients equal the direct route's bit
    for bit, and impl_record says "banded"."""
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=8))
    x_in, y = torch.from_numpy(x[..., :6].copy()), torch.from_numpy(x[..., 6:].copy())
    outs = {}
    for impl in ("masked", "banded"):
        model = build_model(C.ModelConfig(family=family, channels=(3, 8, 3),
                                          k_neighbors=6, knn_window=2,
                                          dtype=dtype, neighbor_impl=impl, seed=2),
                            box=BOX, device="cpu")
        pred = model(x_in)
        torch.mean((pred - y) ** 2).backward()
        outs[impl] = (pred.detach(), [p.grad for p in model.parameters()],
                      model.impl_record["impl"])
    (pd, gd, rd), (pb, gb, rb) = outs["masked"], outs["banded"]
    assert (rd, rb) == ("direct", "banded")
    assert torch.equal(pd, pb)
    assert all(torch.equal(a, b) for a, b in zip(gd, gb))
