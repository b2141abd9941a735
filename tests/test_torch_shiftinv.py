"""Port parity: the shiftinv model (layer, network, registry, mixed
precision), with the JAX parameters loaded through params_from_jax.

f32: outputs to rtol 1e-5; loss and gradients within the normalized bar of
tests/test_grad_parity.py:53-60.  bf16: loss rtol 3e-2 and gradient
cosine > 0.998 (tests/test_grad_parity.py:86-100).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.data.dataset import features_from_raw
from nbody_tpu.data.synthetic import synthetic_raw_cubes
from nbody_tpu.models import shiftinv as js
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.ops.knn import knn_periodic_lattice_batch as j_lattice
from nbody_tpu.physics.losses import loss_za as j_loss

from nbody_tpu_torch import config as C
from nbody_tpu_torch.models import shiftinv as ts
from nbody_tpu_torch.models.base import params_from_jax
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops.route import Route
from nbody_tpu_torch.physics.losses import loss_za

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CELLS = 8
K = 6
BOX = 4.0 * CELLS
CHANNELS = (3, 16, 32, 8, 3)     # both layer branches: q >= C and q < C


def _batch(seed=0):
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=seed))
    return np.ascontiguousarray(x[..., :6]), np.ascontiguousarray(x[..., 6:])


def _pair(dtype, seed=3):
    """The JAX model with its params, and the port model holding them."""
    jcfg = JC.ModelConfig(family="shiftinv", channels=CHANNELS, k_neighbors=K,
                          dtype=dtype, knn_window=2, neighbor_impl="banded",
                          seed=seed)
    jmodel = j_build(jcfg, box=BOX)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = build_model(C.ModelConfig(channels=CHANNELS, k_neighbors=K,
                                       dtype=dtype, knn_window=2), box=BOX,
                         device="cpu")
    tmodel.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _flat_jax_grads(g):
    return np.concatenate([np.concatenate([np.asarray(p["W"]).ravel(),
                                           np.asarray(p["B"]).ravel()])
                           for p in g]).astype(np.float64)


def _flat_torch_grads(model):
    return np.concatenate([np.concatenate([w.grad.numpy().ravel(),
                                           b.grad.numpy().ravel()])
                           for w, b in zip(model.params.W, model.params.B)]
                          ).astype(np.float64)


def _loss_and_grads(dtype):
    x_in, y = _batch()
    jmodel, jparams, tmodel = _pair(dtype)
    # inputs are jit arguments, not closure constants XLA would fold
    jval, jg = jax.jit(jax.value_and_grad(
        lambda p, x, t: j_loss(jmodel.apply(p, x), t)))(
            jparams, jnp.asarray(x_in), jnp.asarray(y))
    pred = tmodel(torch.from_numpy(x_in))
    assert pred.dtype == torch.float32 and pred.shape == (2, CELLS ** 3, 3)
    tval = loss_za(pred, torch.from_numpy(y))
    tval.backward()
    return (float(jval), _flat_jax_grads(jg), float(tval.detach()),
            _flat_torch_grads(tmodel))


def test_forward_matches_f32():
    x_in, _ = _batch(seed=1)
    jmodel, jparams, tmodel = _pair("float32")
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x_in)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x_in)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tmodel.knn_fn(torch.from_numpy(x_in)).numpy(),
        np.asarray(jmodel.knn_fn(jnp.asarray(x_in))))


def test_loss_and_grads_match_f32():
    jval, jg, tval, tg = _loss_and_grads("float32")
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    rms = float(np.sqrt(np.mean(jg ** 2)))
    scale = np.maximum(np.abs(jg), 0.05 * rms)
    np.testing.assert_allclose(tg / scale, jg / scale, rtol=0, atol=2e-3)


def test_loss_and_grads_match_bf16():
    jval, jg, tval, tg = _loss_and_grads("bfloat16")
    assert np.isfinite(tval)
    np.testing.assert_allclose(tval, jval, rtol=3e-2)
    cos = float(jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    assert cos > 0.998, f"gradient cosine similarity {cos}"


@pytest.mark.parametrize("c_in,q,is_last", [(8, 16, False), (16, 4, False),
                                            (8, 3, True)])
def test_layer_matches_f32(c_in, q, is_last):
    rng = np.random.default_rng(c_in * 31 + q)
    h = rng.normal(size=(2, CELLS ** 3, K, c_in)).astype(np.float32)
    w = (rng.normal(size=(4, c_in, q)) * 0.3).astype(np.float32)
    b = rng.normal(size=(1, q)).astype(np.float32)
    x_in, _ = _batch(seed=2)
    pos = x_in[..., :3] + BOX / 2.0 + x_in[..., 3:6]
    idx = np.array(j_lattice(jnp.mod(jnp.asarray(pos) / BOX, 1.0), K,
                             cells=CELLS, window=2))
    want = js.shift_inv_layer(jnp.asarray(h), jnp.asarray(idx),
                              {"W": jnp.asarray(w), "B": jnp.asarray(b)},
                              is_last=is_last)
    route = Route.direct(torch.from_numpy(idx))
    got = ts.shift_inv_layer(torch.from_numpy(h), route,
                             {"W": torch.from_numpy(w), "B": torch.from_numpy(b)},
                             route.counts(), is_last=is_last)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_matches_reference_distributions():
    model = build_model(C.ModelConfig(seed=5), box=C.BOX_SIZE, device="cpu")
    jparams = js.init_shiftinv_params(jax.random.PRNGKey(5), C.GRAPH_CHANNELS)
    assert len(model.params) == len(jparams) == 6
    for w, b, jp in zip(model.params.W, model.params.B, jparams):
        assert tuple(w.shape) == jp["W"].shape and tuple(b.shape) == jp["B"].shape
        assert w.dtype == b.dtype == torch.float32
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jp["B"]))
        std = np.sqrt(2.0 / (w.shape[1] + w.shape[2]))
        assert 0.6 * std < float(w.detach().std()) < 1.4 * std
    again = build_model(C.ModelConfig(seed=5), box=C.BOX_SIZE, device="cpu")
    np.testing.assert_array_equal(again.params.W[0].detach().numpy(),
                                  model.params.W[0].detach().numpy())
    # a non-graph channel list falls back to GRAPH_CHANNELS, as in JAX
    assert len(build_model(C.ModelConfig(channels=(6, 8, 3)),
                           device="cpu").params) == 6


def test_build_model_refuses_unported_families():
    """Every family and neighbor route of the JAX package is ported now:
    shiftinv15 and neighbor_impl="banded" build
    (tests/test_torch_shiftinv15.py, tests/test_torch_knn_methods.py);
    unknown families, dtypes and kNN methods are still refused."""
    model = build_model(C.ModelConfig(family="shiftinv15"), device="cpu")
    assert model.cfg.family == "shiftinv15" and len(model.params) == 6
    assert tuple(model.params.W[0].shape) == (15, 3, 32)
    assert build_model(C.ModelConfig(neighbor_impl="banded"),
                       device="cpu").cfg.neighbor_impl == "banded"
    with pytest.raises(ValueError):
        build_model(C.ModelConfig(knn_method="kd_tree"), device="cpu")
    # the int8 mask route is ported (tests/test_torch_mask_route.py)
    assert build_model(C.ModelConfig(mask_dtype="int8"),
                       device="cpu").cfg.mask_dtype == "int8"
    with pytest.raises(ValueError):
        build_model(C.ModelConfig(family="bogus"), device="cpu")
    with pytest.raises(ValueError):
        build_model(C.ModelConfig(dtype="float16"), device="cpu")


def _network_inputs(dtype, seed=7):
    """Random layer params, edges and a lattice graph, in numpy."""
    rng = np.random.default_rng(seed)
    params = [{"W": (rng.normal(size=(4, a, b)) * 0.3).astype(np.float32),
               "B": rng.normal(size=(1, b)).astype(np.float32)}
              for a, b in zip(CHANNELS[:-1], CHANNELS[1:])]
    x_in, _ = _batch(seed=4)
    pos = x_in[..., :3] + BOX / 2.0 + x_in[..., 3:6]
    idx = np.array(j_lattice(jnp.mod(jnp.asarray(pos) / BOX, 1.0), K,
                             cells=CELLS, window=2))
    edges = rng.normal(size=(2, CELLS ** 3, K, 3)).astype(np.float32)
    ct = rng.normal(size=(2, CELLS ** 3, CHANNELS[-1])).astype(np.float32)
    return params, edges, idx, ct


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_network_over_one_graph_plan_matches_jax(dtype, monkeypatch):
    """The direct route builds the graph plan once and every scatter of the
    network's forward and backward runs over it; outputs and gradients
    (edges and params) match JAX's shiftinv_network."""
    from nbody_tpu_torch.ops import route as troute
    from nbody_tpu_torch.ops.kernels import banded_kernels as tk
    built, plan_of = [], tk.graph_plan

    def counted_plan(idx):
        built.append(idx.shape)
        return plan_of(idx)

    for mod in (troute, tk):
        monkeypatch.setattr(mod, "graph_plan", counted_plan)
    params, edges, idx, ct = _network_inputs(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(p, e):
        out = js.shiftinv_network(p, e, jnp.asarray(idx))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(ct)), out

    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), params)
    (jval, jout), (jgp, jge) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                  has_aux=True)(
        jp, jnp.asarray(edges).astype(jdt))
    tp = [{k: torch.from_numpy(v).to(tdt).requires_grad_() for k, v in p.items()}
          for p in params]
    te = torch.from_numpy(edges).to(tdt).requires_grad_()
    out = ts.shiftinv_network(tp, te, troute.Route.direct(torch.from_numpy(idx)))
    loss = torch.sum(out.float() * torch.from_numpy(ct))
    loss.backward()
    tval = float(loss.detach())
    assert built == [idx.shape] and out.dtype == tdt
    tg = np.concatenate([te.grad.float().numpy().ravel()] + [
        t[k].grad.float().numpy().ravel() for t in tp for k in ("W", "B")])
    jg = np.concatenate([np.asarray(jge.astype(jnp.float32)).ravel()] + [
        np.asarray(j[k].astype(jnp.float32)).ravel() for j in jgp for k in ("W", "B")])
    tg, jg = tg.astype(np.float64), jg.astype(np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tval, float(jval), rtol=1e-5)
        rms = float(np.sqrt(np.mean(jg ** 2)))
        scale = np.maximum(np.abs(jg), 0.05 * rms)
        np.testing.assert_allclose(tg / scale, jg / scale, rtol=0, atol=2e-3)
    else:
        np.testing.assert_allclose(tval, float(jval), rtol=3e-2)
        cos = float(jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg)))
        assert cos > 0.998, f"gradient cosine similarity {cos}"


@pytest.mark.parametrize("family", ["set", "attn"])
def test_build_model_builds_set_and_attn(family):
    """set and attn, refused until they were ported, now build; their
    forward takes the 6-channel input batch and returns f32 residuals."""
    model = build_model(C.ModelConfig(family=family, channels=(6, 8, 3),
                                      dtype="bfloat16"), device="cpu")
    assert model.cfg.family == family and model.impl_record == {}
    x_in = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        out = model(x_in)
    assert out.dtype == torch.float32 and out.shape == (2, CELLS ** 3, 3)


def test_build_model_defaults_to_the_card(monkeypatch):
    """With no device named the model is built on the card, as the CLI's
    --platform cuda; a machine without one refuses, as resolve_device does."""
    from nbody_tpu_torch.models import registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(C.ModelConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.ShiftInvModel(C.ModelConfig(), C.BOX_SIZE)
    for family in ("set", "attn"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(C.ModelConfig(family=family))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert registry.resolve_device() == torch.device("cuda")
    assert registry.resolve_device("cpu") == torch.device("cpu")
    assert build_model(C.ModelConfig(), device="cpu").params.W[0].device.type == "cpu"
