"""Port parity: the integer-mask route (``--mask_dtype int8|int4``,
kernels H/I) of shiftinv and shiftinv_vel, with the JAX parameters loaded
through params_from_jax.

bf16 routes meet JAX's own int8/int4 routes (Pallas mask-dot kernels in
interpret mode) at loss rtol 3e-2 and gradient cosine > 0.998
(tests/test_grad_parity.py:86-100), with the same core and mask dtype in
impl_record; the core steps down under MASKED_BYTES_CAP exactly as JAX's
does.  The int8 route equals the port's own index route up to f32-sum
rounding, and float32 downgrades to the direct kernels, recorded.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.models import registry as jregistry
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.physics.losses import loss_za as j_loss

from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.cli import train as cli_train
from nbody_tpu_torch.data.dataset import features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models import registry
from nbody_tpu_torch.models.base import ShiftInvVelParams, params_from_jax
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops.kernels import mask_kernels
from nbody_tpu_torch.physics.losses import loss_za

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CELLS = 8
K = 6
BOX = 4.0 * CELLS
# two layers each, both layer branches (q >= C and q < C) between them
CHANNELS = {"shiftinv": (3, 16, 3), "shiftinv_vel": (9, 16, 6)}


def _launches(before):
    """The kernel wrappers' launches since the counter snapshot `before`."""
    return {k: v for k, v in tracing.delta(before).items()
            if k.startswith("launch.")}


def _batch(family, seed=0):
    velocity = family == "shiftinv_vel"
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=seed),
                          include_velocity=velocity)
    c = 9 if velocity else 6
    return np.ascontiguousarray(x[..., :c]), np.ascontiguousarray(x[..., c:])


def _port(family, dtype, mask_dtype, masked_core=None):
    return build_model(C.ModelConfig(
        family=family, channels=CHANNELS[family], k_neighbors=K, dtype=dtype,
        knn_window=2, mask_dtype=mask_dtype, masked_core=masked_core), box=BOX,
        device="cpu")


def _pair(family, dtype, mask_dtype, seed=3):
    """The JAX model on the same route with its params, and the port model
    holding them."""
    jmodel = j_build(JC.ModelConfig(
        family=family, channels=CHANNELS[family], k_neighbors=K, dtype=dtype,
        knn_window=2, neighbor_impl="masked", mask_dtype=mask_dtype,
        seed=seed), box=BOX)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = _port(family, dtype, mask_dtype)
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


@pytest.mark.parametrize("mask_dtype", ["int8", "int4"])
@pytest.mark.parametrize("family", ["shiftinv", "shiftinv_vel"])
def test_int_route_matches_jax_bf16(family, mask_dtype):
    x_in, y = _batch(family)
    jmodel, jparams, tmodel = _pair(family, "bfloat16", mask_dtype)
    jval, jg = jax.jit(jax.value_and_grad(
        lambda p, x, t: j_loss(jmodel.apply(p, x), t)))(
            jparams, jnp.asarray(x_in), jnp.asarray(y))
    counts = tracing.counters()
    pred = tmodel(torch.from_numpy(x_in))
    assert pred.dtype == torch.float32 and pred.shape == y.shape
    tval = loss_za(pred, torch.from_numpy(y))
    tval.backward()
    assert not _launches(counts)      # CPU tensors: plain versions
    rec, jrec = tmodel.impl_record, jmodel.impl_record
    assert rec["impl"] == jrec["impl"] == "masked"
    assert rec["core"] == jrec["core"] == [4, 8, 8]
    assert rec["mask_dtype"] == jrec["mask_dtype"] == mask_dtype
    assert rec["mask_bytes"] == jrec["mask_bytes"] // (2 if mask_dtype == "int4" else 1)
    jg, tg = _flat_jax_grads(jg), _flat_torch_grads(tmodel.params)
    tval = float(tval.detach())
    assert np.isfinite(tval)
    np.testing.assert_allclose(tval, float(jval), rtol=3e-2)
    cos = float(jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    assert cos > 0.998, f"gradient cosine similarity {cos}"


@pytest.mark.parametrize("mask_dtype", ["int8", "int4"])
def test_int_route_matches_index_route(mask_dtype):
    """Same params, same batch: the integer-mask route's forward equals the
    index route's up to f32-sum rounding.  Both select exactly and sum in
    f32, in other orders; a sum that lands on a bf16 rounding boundary may
    round the other way and carry one bf16 ulp into the next layer."""
    x_in, _ = _batch("shiftinv_vel", seed=2)
    index = _port("shiftinv_vel", "bfloat16", "index")
    other = _port("shiftinv_vel", "bfloat16", mask_dtype)
    other.params.load_state_dict(index.params.state_dict())
    with torch.no_grad():
        want = index(torch.from_numpy(x_in)).numpy()
        got = other(torch.from_numpy(x_in)).numpy()
    assert other.impl_record["core"] == index.impl_record["core"]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * scale)
    assert np.mean(got == want) > 0.9


def test_f32_int8_downgrade_recorded():
    """Exact-f32 mode downgrades int8 to the direct kernels (JAX downgrades
    to its f32 einsum masks, registry.py:243-249) and records it; the
    output is the direct route's, bit for bit."""
    x_in, _ = _batch("shiftinv", seed=6)
    model = _port("shiftinv", "float32", "int8")
    direct = _port("shiftinv", "float32", "auto")
    direct.params.load_state_dict(model.params.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(x_in))
        want = direct(torch.from_numpy(x_in))
    rec = model.impl_record
    assert rec["impl"] == "direct" and rec["core"] is None
    assert "int8" in rec["downgrade"] and "float32" in rec["downgrade"]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("mask_dtype", ["int8", "int4"])
@pytest.mark.parametrize("cap,want", [(None, [4, 8, 8]), (4 * 2 ** 20, [4, 4, 8]),
                                      (2 * 2 ** 20, [2, 2, 4]),
                                      (1258291, [2, 2, 2]), (1000, None)])
def test_int_core_choice_under_cap(monkeypatch, mask_dtype, cap, want):
    """The first candidate whose masks fit MASKED_BYTES_CAP, estimated at
    one byte per entry for int8 and int4 alike, as JAX's registry chooses
    it; nothing fits -> the block route, with a warning."""
    if cap is not None:
        monkeypatch.setattr(registry, "MASKED_BYTES_CAP", cap)
        monkeypatch.setattr(jregistry, "MASKED_BYTES_CAP", cap)
    idx = np.zeros((2, CELLS ** 3, K), np.int32)
    jcfg = JC.ModelConfig(family="shiftinv", k_neighbors=K, knn_window=2,
                          neighbor_impl="masked", mask_dtype=mask_dtype)
    jrec = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jmasks, _ = jregistry._make_masks(jcfg, (CELLS, 2), jnp.asarray(idx),
                                          jnp.bfloat16, jrec)
        route = registry._make_route(
            C.ModelConfig(k_neighbors=K, knn_window=2, mask_dtype=mask_dtype),
            CELLS, CELLS ** 3, torch.from_numpy(idx), torch.bfloat16)
    rec, masks = route.record(), route.plan
    if want is None:
        # JAX records no core for its block fallback; the port names the
        # block route's own
        assert jmasks is None and route.kind == "block"
        assert jrec["impl"] == rec["impl"] == "block" and jrec["core"] is None
        assert rec["core"] == [4, 4, 8] and (route.cells, route.window) == (CELLS, 2)
        assert "cap" in rec["downgrade"]
        assert sum("falling back" in str(w.message) for w in caught) == 2
        return
    assert rec["core"] == jrec["core"] == want
    assert rec["mask_dtype"] == jrec["mask_dtype"] == mask_dtype == route.kind
    assert (route.cells, route.window, route.core) == (CELLS, 2, tuple(want))
    assert masks.shape[:3] == jmasks.shape[:3]
    assert mask_kernels.patch_width(masks) == jmasks.shape[3]
    assert rec["mask_bytes"] == masks.numel() * masks.element_size()


def test_masked_core_with_int8():
    """--masked_core with --mask_dtype int8 (or int4) is accepted, and the
    core it names is the route's; with the direct route it stays refused."""
    for mdt in ("int8", "int4"):
        args = C.build_parser().parse_args(
            ["--mask_dtype", mdt, "--masked_core", "2", "2", "2",
             "--dtype", "bfloat16"])
        cfg = C.config_from_args(args)
        assert (cfg.model.mask_dtype, cfg.model.masked_core) == (mdt, (2, 2, 2))
    with pytest.raises(NotImplementedError):
        C.config_from_args(C.build_parser().parse_args(
            ["--masked_core", "2", "2", "2"]))
    x_in, _ = _batch("shiftinv", seed=4)
    model = _port("shiftinv", "bfloat16", "int8", masked_core=(2, 2, 2))
    counts = tracing.counters()
    with torch.no_grad():
        out = model(torch.from_numpy(x_in))
    assert torch.isfinite(out).all()
    assert model.impl_record["core"] == [2, 2, 2]
    assert model.impl_record["mask_dtype"] == "int8"
    assert not _launches(counts)


@pytest.mark.parametrize("mask_dtype", ["int8", "int4"])
def test_cli_int_masks_cpu(capsys, mask_dtype, tmp_path, monkeypatch):
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path))
    rc = cli_train.main(["--platform", "cpu", "--mask_dtype", mask_dtype,
                         "--dtype", "bfloat16", "--cells", "8", "-k", "6",
                         "--knn_window", "2", "-c", "3", "8", "3", "-i", "2",
                         "-b", "2", "-t", "2", "--samples", "8", "--synthetic"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Training finished!" in out and "# Test Error" in out
    assert (f"'impl': 'masked', 'core': [4, 8, 8], 'mask_dtype': "
            f"'{mask_dtype}'") in out
