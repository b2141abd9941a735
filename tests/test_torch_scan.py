"""Trainer.fit_scan and TrainScan (the port of make_train_scan /
make_train_scan_device) on the CPU, where the step runs eagerly T times a
chunk; on the card the same step is a replayed CUDA graph (chip_smoke.py
phase 14).

fit_scan must give fit's losses and parameters bit for bit for the same
minibatch generator, with device_data on and off; the port's scan over
three explicit batches tracks the JAX make_train_scan from the same
parameters at the bars of test_adam_steps_track_optax (f32 loss rtol 1e-4,
last-layer W rtol 1e-3 / atol 1e-6).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nbody_tpu import config as JC
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.train.trainer import TrainState, make_train_scan

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import Dataset, features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models.base import params_from_jax
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.train.trainer import (CoverageError, Trainer, TrainScan,
                                           make_optimizer)

torch.set_num_threads(1)

CELLS = 8


def _cfg(device_data="auto", **model):
    return C.Config(
        data=C.DataConfig(data_dir=os.path.join(os.sep, "nonexistent"),
                          num_test=2, num_val=1, cells_per_side=CELLS,
                          synthetic_num_samples=12),
        model=C.ModelConfig(channels=(3, 8, 8, 3), k_neighbors=6,
                            knn_window=2, seed=4, **model),
        train=C.TrainConfig(num_iters=12, batch_size=2, learn_rate=1e-3,
                            checkpoint_every=1, device_data=device_data))


def _params(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_scan_equals_fit(dtype):
    """Chunks of 5 over 12 steps: the losses at the chunk ends and the
    parameters bit-equal to fit's, one record a chunk, the global step."""
    cfg = _cfg(dtype=dtype)
    ds = Dataset(cfg.data)
    eager = Trainer(cfg, "cpu", dataset=ds)
    eager.fit(verbose=False)
    scan = Trainer(cfg, "cpu", dataset=ds)
    last = scan.fit_scan(scan_chunk=5, verbose=False)
    per_step = {r["step"]: r["loss"] for r in eager.metrics_log if "step" in r}
    assert scan.train_error_history == [per_step[5], per_step[10], per_step[12]]
    assert last == per_step[12]
    recs = [r for r in scan.metrics_log if "step" in r]
    assert [r["step"] for r in recs] == [5, 10, 12]
    assert all(r["coverage_margin_violations"] == 0 for r in recs)
    assert "effective_neighbor_impl" in scan.metrics_log[0]
    assert eager.step == scan.step == 12
    for a, b in zip(_params(eager), _params(scan)):
        assert torch.equal(a, b)


def test_device_data_on_equals_off():
    ds = Dataset(_cfg().data)
    runs = []
    for mode in ("on", "off"):
        t = Trainer(_cfg(device_data=mode), "cpu", dataset=ds)
        assert t._device_data_enabled() == (mode == "on")
        t.fit_scan(scan_chunk=5, verbose=False)
        assert (t._x_dev is not None) == (mode == "on")
        runs.append((t.train_error_history, _params(t)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_device_data_auto_follows_the_cap(monkeypatch):
    """auto keeps X_train on the device while it fits
    NBODY_DEVICE_DATA_CAP_GB, as the JAX _device_data_enabled does (the
    port has no mesh, so no sharded exception); on and off are absolute."""
    ds = Dataset(_cfg().data)
    auto = Trainer(_cfg(), "cpu", dataset=ds)
    monkeypatch.delenv("NBODY_DEVICE_DATA_CAP_GB", raising=False)
    assert auto._device_data_enabled()                 # tiny set, 6 GiB cap
    monkeypatch.setenv("NBODY_DEVICE_DATA_CAP_GB", "0")
    assert not auto._device_data_enabled()             # over the budget
    assert Trainer(_cfg(device_data="on"), "cpu", dataset=ds)._device_data_enabled()
    monkeypatch.setenv("NBODY_DEVICE_DATA_CAP_GB", "100")
    assert not Trainer(_cfg(device_data="off"), "cpu",
                       dataset=ds)._device_data_enabled()
    cap = ds.X_train.nbytes / 2 ** 30
    monkeypatch.setenv("NBODY_DEVICE_DATA_CAP_GB", repr(cap))
    assert auto._device_data_enabled()                 # the cap is inclusive


def test_fit_scan_refuses_uncovered_graph():
    raw = synthetic_raw_cubes(8, CELLS, seed=5)
    raw[..., 1:4] *= 6.0          # displacements far beyond a 1-cell window
    cfg = _cfg()
    cfg = C.Config(cfg.data, C.ModelConfig(channels=(3, 8, 3), k_neighbors=14,
                                           knn_window=1), cfg.train)
    trainer = Trainer(cfg, "cpu", dataset=Dataset(cfg.data, raw=raw))
    with pytest.raises(CoverageError):
        trainer.fit_scan(scan_chunk=4, verbose=False)
    assert trainer.step == 0
    with pytest.raises(ValueError):
        trainer.fit_scan(scan_chunk=0, verbose=False)


def test_scan_tracks_jax_make_train_scan():
    """From the same parameters and three explicit batches: JAX
    make_train_scan (lax.scan of the jitted step) against the port's
    TrainScan.run and, on the same batches by index, run_indexed."""
    channels, k, lr = (3, 16, 8, 3), 6, 3e-3
    x = features_from_raw(synthetic_raw_cubes(6, CELLS, seed=8))
    batches = np.stack([x[2 * i:2 * i + 2] for i in range(3)])
    jmodel = j_build(JC.ModelConfig(family="shiftinv", channels=channels,
                                    k_neighbors=k, knn_window=2,
                                    neighbor_impl="banded"), box=4.0 * CELLS)
    params = jmodel.init(jax.random.PRNGKey(2))
    np_params = jax.tree_util.tree_map(np.array, params)   # state is donated
    opt = optax.adam(lr)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    state, j_losses = make_train_scan(jmodel, opt)(state, jnp.asarray(batches), 6)
    j_w = np.asarray(state.params[-1]["W"])

    for indexed in (False, True):
        tmodel = build_model(C.ModelConfig(channels=channels, k_neighbors=k,
                                           knn_window=2), box=4.0 * CELLS,
                             device="cpu")
        tmodel.params = params_from_jax(np_params)
        scan = TrainScan(tmodel, make_optimizer(tmodel, lr))
        if indexed:
            losses = scan.run_indexed(torch.from_numpy(x),
                                      torch.arange(6).reshape(3, 2), 6)
        else:
            losses = scan.run(torch.from_numpy(batches), 6)
        assert losses.shape == (3,)
        np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), rtol=1e-4)
        np.testing.assert_allclose(tmodel.params.W[-1].detach().numpy(), j_w,
                                   rtol=1e-3, atol=1e-6)
