"""Port parity: the lattice kNN and kernel A's plain version.

The lattice graph must be bit-equal to nbody_tpu's (same slots, same order,
same lowest-slot tie breaks), windows 2 and 3, including an undisplaced
grid where every distance ties.  The plain selection must be bit-equal to
jax.lax.top_k(-d2) and to the Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.data.synthetic import synthetic_raw_cubes
from nbody_tpu.models.registry import coverage_violations as j_coverage
from nbody_tpu.ops import knn as jknn
from nbody_tpu.ops.pallas.topk_kernels import topk_min_pallas

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import features_from_raw
from nbody_tpu_torch.models.registry import coverage_violations
from nbody_tpu_torch.ops import knn as tknn
from nbody_tpu_torch.ops.kernels.topk_kernels import topk_min, topk_min_plain

torch.set_num_threads(1)


def _positions(cells, seed, displaced=True, za_scale=1.0):
    x = features_from_raw(synthetic_raw_cubes(2, cells, seed=seed))
    box = 4.0 * cells
    pos = x[..., :3] + box / 2.0
    if displaced:
        pos = pos + za_scale * x[..., 3:6]
    return np.ascontiguousarray(pos), x


def _norm(pos, box):
    pn_t = torch.remainder(torch.from_numpy(pos) / box, 1.0)
    pn_j = jnp.mod(jnp.asarray(pos) / box, 1.0)
    np.testing.assert_array_equal(pn_t.numpy(), np.asarray(pn_j))
    return pn_t, pn_j


@pytest.mark.parametrize("cells", [8, 16])
@pytest.mark.parametrize("window", [2, 3])
@pytest.mark.parametrize("displaced", [True, False])
def test_lattice_knn_bit_equal(cells, window, displaced):
    pos, _ = _positions(cells, seed=11, displaced=displaced)
    pn_t, pn_j = _norm(pos, 4.0 * cells)
    k = 6 if cells == 8 else 14
    want = np.asarray(jknn.knn_periodic_lattice_batch(
        pn_j, k, cells=cells, window=window))
    got = tknn.knn_periodic_lattice_batch(pn_t, k, cells=cells, window=window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy()[..., 0], np.broadcast_to(np.arange(cells ** 3), got.shape[:2]))


def test_single_cube_lattice_knn_bit_equal():
    pos, _ = _positions(8, seed=2)
    pn_t, pn_j = _norm(pos[0], 32.0)
    want = np.asarray(jknn.knn_periodic_lattice(pn_j, 6, cells=8, window=2))
    got = tknn.knn_periodic_lattice(pn_t, 6, cells=8, window=2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lattice_knn_rejects_non_cube():
    with pytest.raises(ValueError):
        tknn.knn_periodic_lattice_batch(torch.rand(1, 100, 3), 6, cells=5)


def _topk_inputs():
    rng = np.random.default_rng(1)
    d2 = rng.random((512, 125)).astype(np.float32)
    return {"random": d2, "quantized": np.floor(d2 * 8.0)}


@pytest.mark.parametrize("case", ["random", "quantized"])
@pytest.mark.parametrize("k", [1, 14, 32])
def test_topk_plain_matches_top_k_and_pallas(case, k):
    d2 = _topk_inputs()[case]
    got = topk_min_plain(torch.from_numpy(d2), k).numpy()
    _, want = jax.lax.top_k(-jnp.asarray(d2), k)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, np.asarray(topk_min_pallas(jnp.asarray(d2), k, interpret=True)))
    # the dispatching wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(topk_min(torch.from_numpy(d2), k).numpy(), got)


def test_topk_plain_inf_nan_order():
    d2x = np.asarray([[0.5, np.inf, 0.2, np.inf]] * 8, np.float32)
    got = topk_min_plain(torch.from_numpy(d2x), 4).numpy()
    assert (np.sort(got, axis=1) == np.arange(4)).all()
    np.testing.assert_array_equal(got[0], [2, 0, 1, 3])
    rng = np.random.default_rng(2)
    d2 = rng.random((64, 125)).astype(np.float32)
    d2[rng.random(d2.shape) < 0.2] = np.inf
    d2[rng.random(d2.shape) < 0.2] = np.nan
    d2[:, 7] = np.nan        # NaN > +inf > finite
    d2[:4] = np.inf           # rows with no finite candidate
    got = topk_min_plain(torch.from_numpy(d2), 14).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(topk_min_pallas(jnp.asarray(d2), 14, interpret=True)))
    assert all(len(set(r)) == 14 for r in got.tolist())


def test_topk_wrapper_refuses_other_devices_and_shapes():
    with pytest.raises(ValueError):
        topk_min(torch.empty((8, 125), device="meta"), 14)
    with pytest.raises(ValueError):
        topk_min(torch.rand(8, 10), 14)           # k > M
    with pytest.raises(ValueError):
        topk_min(torch.rand(8, 125), 33)          # k > KMAX
    with pytest.raises(ValueError):
        topk_min(torch.rand(2, 8, 125), 14)


def test_exact_knn_matches_jax():
    pos, _ = _positions(8, seed=3)
    pn_t, pn_j = _norm(pos, 32.0)
    want = np.asarray(jknn.knn_periodic_batch(pn_j, 14, row_chunk=200))
    got = tknn.knn_periodic_batch(pn_t, 14, row_chunk=200)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [1, 2])
def test_lattice_violations_match(window):
    pos, _ = _positions(8, seed=5, za_scale=4.0)
    got = tknn.lattice_violations(torch.from_numpy(pos), 8, box=32.0,
                                  window=window)
    want = jknn.lattice_violations(jnp.asarray(pos), 8, box=32.0,
                                   window=window)
    assert int(got) == int(want)
    assert window == 2 or int(got) > 0


@pytest.mark.parametrize("za_scale,window", [(1.0, 2), (6.0, 1)])
def test_coverage_violations_match_jax(za_scale, window):
    _, x = _positions(8, seed=5)
    x = x.copy()
    x[..., 3:6] *= za_scale
    x_in = x[..., :6]
    tcfg = C.ModelConfig(k_neighbors=14, knn_window=window)
    jcfg = JC.ModelConfig(family="shiftinv", k_neighbors=14, knn_window=window)
    got = coverage_violations(tcfg, 32.0, torch.from_numpy(x_in))
    want = j_coverage(jcfg, 32.0, x_in)
    assert got == want
    assert (got == 0) == (za_scale == 1.0)
