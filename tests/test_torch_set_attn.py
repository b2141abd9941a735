"""Port parity: the set and attn families (models/set_net.py,
models/attn.py, their registry models), with the JAX parameters loaded
through params_from_jax, on the same numpy-seeded 8^3 batches.

f32: set forwards and gradients to rtol 1e-5 / atol 1e-6; attn (three
layers of width 8) to rtol 1e-4 / atol 1e-5, in train and eval mode and
with both gate forms.  bf16 through build_model at the repo's bars: loss
rtol 3e-2, gradient cosine > 0.998.  Then the trainer (fit = fit_scan,
evaluate through eval_fn) and the cli.experiment entry point.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.cli import experiment as j_experiment
from nbody_tpu.data.dataset import features_from_raw
from nbody_tpu.data.synthetic import synthetic_raw_cubes
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.physics.losses import loss_za as j_loss

from nbody_tpu_torch import config as C
from nbody_tpu_torch.cli import experiment as t_experiment
from nbody_tpu_torch.data.dataset import Dataset
from nbody_tpu_torch.models.base import params_from_jax
from nbody_tpu_torch.models.registry import AttnModel, SetModel, build_model
from nbody_tpu_torch.physics.losses import loss_za
from nbody_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CELLS = 8
SET_CHANNELS = (6, 16, 32, 8, 3)
ATTN_CHANNELS = (6, 8, 8, 3)
F32_TOL = {"set": dict(rtol=1e-5, atol=1e-6), "attn": dict(rtol=1e-4, atol=1e-5)}


def _batch(seed=0):
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=seed))
    return np.ascontiguousarray(x[..., :6]), np.ascontiguousarray(x[..., 6:])


def _pair(family, dtype="float32", gate=True, seed=3):
    """The JAX model with its params, and the port model holding them."""
    channels = SET_CHANNELS if family == "set" else ATTN_CHANNELS
    jmodel = j_build(JC.ModelConfig(family=family, channels=channels,
                                    dtype=dtype, batch_coupled_gate=gate),
                     box=4.0 * CELLS)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = build_model(C.ModelConfig(family=family, channels=channels,
                                       dtype=dtype, batch_coupled_gate=gate),
                         box=4.0 * CELLS, device="cpu")
    tmodel.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _loss_and_grads(family, dtype, gate=True, train_mode=True):
    """(JAX loss, JAX grads, port loss, port grads); grads as flat f64
    arrays in one per-layer, per-key order."""
    x_in, y = _batch()
    jmodel, jparams, tmodel = _pair(family, dtype, gate)
    jfwd = jmodel.apply if train_mode else jmodel.eval_fn
    tfwd = tmodel if train_mode else tmodel.eval_fn
    jval, jg = jax.jit(jax.value_and_grad(
        lambda p, x, t: j_loss(jfwd(p, x), t)))(
            jparams, jnp.asarray(x_in), jnp.asarray(y))
    pred = tfwd(torch.from_numpy(x_in))
    assert pred.dtype == torch.float32 and pred.shape == (2, CELLS ** 3, 3)
    tval = loss_za(pred, torch.from_numpy(y))
    tval.backward()
    tlayers = tmodel.params.layers()
    keys = sorted(tlayers[0])
    flat_j = np.concatenate([np.asarray(g[k]).ravel() for g in jg for k in keys])
    # the last layer's R, gamma and beta take no part (zero JAX gradient)
    flat_t = np.concatenate([
        (t[k].grad if t[k].grad is not None else torch.zeros_like(t[k]))
        .numpy().ravel() for t in tlayers for k in keys])
    return (float(jval), flat_j.astype(np.float64), float(tval.detach()),
            flat_t.astype(np.float64))


@pytest.mark.parametrize("family,gate,train_mode", [
    ("set", True, True), ("attn", True, True), ("attn", True, False),
    ("attn", False, True), ("attn", False, False)])
def test_forward_and_grads_match_f32(family, gate, train_mode):
    x_in, _ = _batch(seed=1)
    jmodel, jparams, tmodel = _pair(family, gate=gate)
    jfwd = jmodel.apply if train_mode else jmodel.eval_fn
    want = np.asarray(jax.jit(jfwd)(jparams, jnp.asarray(x_in)))
    with torch.no_grad():
        fwd = tmodel if train_mode else tmodel.eval_fn
        got = fwd(torch.from_numpy(x_in)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL[family])
    jval, jg, tval, tg = _loss_and_grads(family, "float32", gate, train_mode)
    np.testing.assert_allclose(tval, jval, **F32_TOL[family])
    np.testing.assert_allclose(tg, jg, **F32_TOL[family])


@pytest.mark.parametrize("family", ["set", "attn"])
def test_loss_and_grads_match_bf16(family):
    jval, jg, tval, tg = _loss_and_grads(family, "bfloat16")
    assert np.isfinite(tval)
    np.testing.assert_allclose(tval, jval, rtol=3e-2)
    cos = float(jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg)))
    assert cos > 0.998, f"gradient cosine similarity {cos}"


def test_train_and_eval_modes_differ_only_for_attn():
    """attn's eval_fn freezes the batch statistics: it does not depend on
    the rest of the batch, and it differs from the train-mode forward;
    set's eval_fn is its forward."""
    x_in = torch.from_numpy(_batch(seed=2)[0])
    _, _, attn = _pair("attn")
    _, _, set_model = _pair("set")
    with torch.no_grad():
        assert not torch.allclose(attn(x_in), attn.eval_fn(x_in))
        torch.testing.assert_close(attn.eval_fn(x_in)[:1],
                                   attn.eval_fn(x_in[:1]))
        assert torch.equal(set_model.eval_fn(x_in), set_model(x_in))


def _cfg(family, channels, **train):
    return C.Config(
        data=C.DataConfig(data_dir=os.path.join(os.sep, "nonexistent"),
                          num_test=2, num_val=1, cells_per_side=CELLS,
                          synthetic_num_samples=10),
        model=C.ModelConfig(family=family, channels=channels, seed=4),
        train=C.TrainConfig(num_iters=6, batch_size=2, learn_rate=1e-3,
                            checkpoint_every=1, **train))


@pytest.mark.parametrize("family", ["set", "attn"])
def test_fit_scan_equals_fit_and_evaluate(family):
    """fit_scan (chunks of 4) gives fit's losses and parameters bit for bit;
    no coverage check or margin record runs for a family without a graph;
    evaluate's predictions are the model's eval_fn."""
    cfg = _cfg(family, SET_CHANNELS if family == "set" else ATTN_CHANNELS)
    ds = Dataset(cfg.data)
    eager = Trainer(cfg, "cpu", dataset=ds)
    eager.fit(verbose=False)
    scan = Trainer(cfg, "cpu", dataset=ds)
    scan.fit_scan(scan_chunk=4, verbose=False)
    per_step = {r["step"]: r["loss"] for r in eager.metrics_log if "step" in r}
    assert scan.train_error_history == [per_step[4], per_step[6]]
    for a, b in zip(eager.model.parameters(), scan.model.parameters()):
        assert torch.equal(a, b)
    for log in (eager.metrics_log, scan.metrics_log):
        assert not any("coverage_margin_violations" in r
                       or "graph_coverage_violations" in r for r in log)
    errors, preds = scan.evaluate(verbose=False)
    with torch.no_grad():
        want = scan.model.eval_fn(torch.from_numpy(ds.X_test[:2, :, :6]))
    np.testing.assert_array_equal(preds[1], want.numpy())
    assert np.isfinite(errors).all()


def test_families_build_with_the_jax_channel_fallbacks():
    """set and attn take CHANNELS / ATTN_CHANNELS when the list does not
    start at 6 (registry.py:343, :464); attn's init is the JAX one's
    (biases 1e-6, gamma 1, beta 0, R (6, k_out))."""
    set_model = build_model(C.ModelConfig(family="set", channels=(3, 8, 3)),
                            device="cpu")
    assert isinstance(set_model, SetModel)
    assert [tuple(w.shape) for w in set_model.params.W] == [
        (1, a, b) for a, b in zip(C.CHANNELS[:-1], C.CHANNELS[1:])]
    attn = build_model(C.ModelConfig(family="attn", channels=(3, 8, 3)),
                       device="cpu")
    assert isinstance(attn, AttnModel) and len(attn.params) == 23
    layer = attn.params.layers()[0]
    assert tuple(layer["R"].shape) == (6, 16) and tuple(layer["Wf"].shape) == (6, 16)
    assert torch.all(layer["B"] == 1e-6) and torch.all(layer["gamma"] == 1)
    assert torch.all(layer["beta"] == 0)
    jp = j_build(JC.ModelConfig(family="attn", channels=(6, 8, 3))).init(
        jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in jp[1].items()} == {
        k: tuple(v.shape) for k, v in build_model(
            C.ModelConfig(family="attn", channels=(6, 8, 3)),
            device="cpu").params.layers()[1].items()}


def test_experiment_forwards_the_jax_flags(monkeypatch):
    """cli.experiment forwards what the JAX entry point forwards, with the
    same defaults, apart from --platform (cuda|cpu here, auto there)."""
    seen = {}
    monkeypatch.setattr(j_experiment, "train_main",
                        lambda argv: seen.setdefault("jax", argv) and 0)
    monkeypatch.setattr(t_experiment, "train_main",
                        lambda argv: seen.setdefault("torch", argv) and 0)
    for argv in ([], ["-i", "20", "-b", "4", "-n", "x", "--cells", "16",
                      "--synthetic"]):
        seen.clear()
        j_experiment.main(argv)
        t_experiment.main(argv)

        def drop_platform(a):
            i = a.index("--platform")
            return a[:i] + a[i + 2:]

        assert drop_platform(seen["torch"]) == drop_platform(seen["jax"])
        assert seen["torch"][seen["torch"].index("--platform") + 1] == "cuda"
        cfg = C.config_from_args(C.build_parser().parse_args(seen["torch"]))
        assert cfg.model.family == "attn" and cfg.model.channels == tuple(
            C.ATTN_CHANNELS)
        assert cfg.train.learn_rate == 0.006
        if not argv:
            assert (cfg.train.num_iters, cfg.train.batch_size,
                    cfg.train.name) == (100000, 10, "TEST")


def test_experiment_cli_trains_attn_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path))
    monkeypatch.setattr(C, "NUM_SAMPLES", 10)
    rc = t_experiment.main(["--platform", "cpu", "-i", "2", "-b", "2",
                            "--cells", "4", "--synthetic", "-n", "attn"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Training (attn" in out and "median :" in out
    assert os.path.exists(tmp_path / "ZA-FPM_0_attn" / "Results" /
                          "X_0_prediction.npy")
