"""Port parity: neighbor gather / scatter-add (kernels B and C's plain
versions and their autograd Functions) and the edge features.

Gather in f32 is exact: equal to nbody_tpu's neighbor_gather and to the
Pallas banded gather in interpret mode (fast=False).  Scatter, counts and
segment mean match to rtol 1e-6 (f32 summation order) and np.add.at.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu.ops import banded as jb
from nbody_tpu.ops import graph_features as jgf
from nbody_tpu.ops.knn import knn_periodic_lattice_batch as j_lattice
from nbody_tpu.ops.pallas.banded_kernels import (banded_gather_pallas,
                                                 banded_scatter_add_pallas)

from nbody_tpu_torch.data.dataset import features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.ops import banded as tb
from nbody_tpu_torch.ops import graph_features as tgf
from nbody_tpu_torch.ops.kernels import banded_kernels as K
from nbody_tpu_torch.ops.kernels import build

torch.set_num_threads(1)

CELLS = 8
N = CELLS ** 3


def _inputs(c, k=6, b=2, seed=0):
    """Values and a real lattice-kNN graph (plus a few random far edges)."""
    rng = np.random.default_rng(seed)
    pos = (_grid01()[None] + 0.02 * rng.random((b, N, 3))).astype(np.float32)
    idx = np.array(j_lattice(jnp.mod(jnp.asarray(pos), 1.0), k, cells=CELLS,
                             window=2))
    idx[:, ::37, -1] = rng.integers(0, N, size=idx[:, ::37, -1].shape)
    values = rng.normal(size=(b, N, c)).astype(np.float32)
    edge_vals = rng.normal(size=(b, N, k, c)).astype(np.float32)
    return values, idx.astype(np.int32), edge_vals


def _grid01():
    ax = (np.arange(CELLS) + 0.5) / CELLS
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("c", [1, 3, 16])
def test_gather_exact_f32(c):
    values, idx, _ = _inputs(c)
    got = tb.neighbor_gather(torch.from_numpy(values), torch.from_numpy(idx))
    want = np.asarray(jb.neighbor_gather(jnp.asarray(values), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), values[np.arange(2)[:, None, None], idx])
    pallas = banded_gather_pallas(jnp.asarray(values), jnp.asarray(idx),
                                  interpret=True, fast=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_gather_bf16_is_a_copy():
    values, idx, _ = _inputs(8)
    tv = torch.from_numpy(values).to(torch.bfloat16)
    got = tb.neighbor_gather(tv, torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    want = jb.neighbor_gather(jnp.asarray(values).astype(jnp.bfloat16),
                              jnp.asarray(idx))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("c", [1, 3, 16])
def test_scatter_add_matches(c):
    _, idx, ev = _inputs(c)
    got = tb.neighbor_scatter_add(torch.from_numpy(ev), torch.from_numpy(idx))
    want = np.asarray(jb.neighbor_scatter_add(jnp.asarray(ev), jnp.asarray(idx)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ref = np.zeros((2, N, c), np.float64)
    for bi in range(2):
        np.add.at(ref[bi], idx[bi].reshape(-1), ev[bi].reshape(-1, c))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)
    pallas = banded_scatter_add_pallas(jnp.asarray(ev), jnp.asarray(idx),
                                       interpret=True, fast=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-6,
                               atol=1e-5)


def test_counts_and_segment_mean_match():
    _, idx, ev = _inputs(4)
    ti, te = torch.from_numpy(idx), torch.from_numpy(ev)
    cnt = tb.neighbor_counts(ti)
    np.testing.assert_array_equal(
        cnt.numpy(), np.asarray(jb.neighbor_counts(jnp.asarray(idx))))
    np.testing.assert_array_equal(cnt.sum(dim=1).numpy(), [N * 6, N * 6])
    want = np.asarray(jb.neighbor_segment_mean(jnp.asarray(ev), jnp.asarray(idx)))
    for counts in (None, cnt):
        got = tb.neighbor_segment_mean(te, ti, counts=counts)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_gradcheck_f64():
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 5, size=(2, 5, 3)).astype(np.int32))
    v = torch.from_numpy(rng.normal(size=(2, 5, 2))).requires_grad_()
    e = torch.from_numpy(rng.normal(size=(2, 5, 3, 2))).requires_grad_()
    assert torch.autograd.gradcheck(lambda x: tb.neighbor_gather(x, idx), (v,))
    assert torch.autograd.gradcheck(lambda x: tb.neighbor_scatter_add(x, idx), (e,))


def test_grads_match_jax_vjp():
    values, idx, ev = _inputs(3, seed=5)
    ct_g = np.random.default_rng(6).normal(size=ev.shape).astype(np.float32)
    ct_s = np.random.default_rng(7).normal(size=values.shape).astype(np.float32)
    tv = torch.from_numpy(values).requires_grad_()
    te = torch.from_numpy(ev).requires_grad_()
    ti = torch.from_numpy(idx)
    (gv,) = torch.autograd.grad(tb.neighbor_gather(tv, ti),
                                tv, torch.from_numpy(ct_g))
    (ge,) = torch.autograd.grad(tb.neighbor_scatter_add(te, ti),
                                te, torch.from_numpy(ct_s))
    _, vjp_g = jax.vjp(lambda v: jb.neighbor_gather(v, jnp.asarray(idx)),
                       jnp.asarray(values))
    _, vjp_s = jax.vjp(lambda e: jb.neighbor_scatter_add(e, jnp.asarray(idx)),
                       jnp.asarray(ev))
    np.testing.assert_allclose(gv.numpy(), np.asarray(vjp_g(jnp.asarray(ct_g))[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ge.numpy(),
                                  np.asarray(vjp_s(jnp.asarray(ct_s))[0]))


def test_wrappers_refuse_bad_inputs():
    values, idx, ev = _inputs(3)
    tv, ti, te = (torch.from_numpy(a) for a in (values, idx, ev))
    with pytest.raises(ValueError):
        K.neighbor_gather(tv.to("meta"), ti.to("meta"))
    with pytest.raises(ValueError):
        K.neighbor_scatter_add(te.to("meta"), ti.to("meta"))
    with pytest.raises(ValueError):
        K.neighbor_gather(tv, ti.long())
    with pytest.raises(ValueError):
        K.neighbor_scatter_add(te[:, :, :2], ti)
    with pytest.raises(ValueError):
        K.neighbor_gather(tv[:1], ti)


def test_kernel_build_is_content_addressed(tmp_path, monkeypatch):
    for name in ("topk_kernels", "banded_kernels", "block_kernels"):
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
        with open(build.source_path(name)) as f:
            src = f.read()
        assert 'extern "C"' in src and "nbody_tpu/ops/pallas/" in src
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.KernelBuildError):
        build.find_nvcc()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_features_za_match(dtype):
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=4))
    box = 4.0 * CELLS
    pos = np.ascontiguousarray(x[..., :3] + box / 2.0 + x[..., 3:6])
    za = np.ascontiguousarray(x[..., 3:6])
    idx = np.array(j_lattice(jnp.mod(jnp.asarray(pos) / box, 1.0), 6,
                             cells=CELLS, window=2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jgf.edge_features_za(jnp.asarray(pos).astype(jdt), jnp.asarray(idx),
                                jnp.asarray(za).astype(jdt), box)
    got = tgf.edge_features_za(torch.from_numpy(pos).to(tdt),
                               torch.from_numpy(idx),
                               torch.from_numpy(za).to(tdt), box)
    assert got.dtype == tdt and got.shape == (2, N, 6, 3)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        # bf16 elementwise rounding differs between the frameworks (XLA may
        # keep excess precision inside a fusion); bf16 ulp at |x| < 8 is
        # 2^-5, and the displacement trick keeps |edges| small
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2 ** -4)
