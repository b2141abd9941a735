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
                                       dtype=dtype, knn_window=2), box=BOX)
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
    got = ts.shift_inv_layer(torch.from_numpy(h), torch.from_numpy(idx),
                             {"W": torch.from_numpy(w), "B": torch.from_numpy(b)},
                             is_last=is_last)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_matches_reference_distributions():
    model = build_model(C.ModelConfig(seed=5), box=C.BOX_SIZE)
    jparams = js.init_shiftinv_params(jax.random.PRNGKey(5), C.GRAPH_CHANNELS)
    assert len(model.params) == len(jparams) == 6
    for w, b, jp in zip(model.params.W, model.params.B, jparams):
        assert tuple(w.shape) == jp["W"].shape and tuple(b.shape) == jp["B"].shape
        assert w.dtype == b.dtype == torch.float32
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jp["B"]))
        std = np.sqrt(2.0 / (w.shape[1] + w.shape[2]))
        assert 0.6 * std < float(w.detach().std()) < 1.4 * std
    again = build_model(C.ModelConfig(seed=5), box=C.BOX_SIZE)
    np.testing.assert_array_equal(again.params.W[0].detach().numpy(),
                                  model.params.W[0].detach().numpy())
    # a non-graph channel list falls back to GRAPH_CHANNELS, as in JAX
    assert len(build_model(C.ModelConfig(channels=(6, 8, 3))).params) == 6


def test_build_model_refuses_unported_families():
    for fam in ("set", "attn", "shiftinv15"):
        with pytest.raises(NotImplementedError):
            build_model(C.ModelConfig(family=fam))
    for cfg in (C.ModelConfig(neighbor_impl="banded"),
                C.ModelConfig(mask_dtype="int8")):
        with pytest.raises(NotImplementedError):
            build_model(cfg)
    with pytest.raises(ValueError):
        build_model(C.ModelConfig(family="bogus"))
    with pytest.raises(ValueError):
        build_model(C.ModelConfig(dtype="float16"))
