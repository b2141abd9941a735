"""Port parity and end-to-end runs: train step, Trainer, CLI, import rules.

Three Adam steps from the same params and batches track the JAX/optax
losses to rtol 1e-4 in f32; Trainer.fit/evaluate and the CLI run end to
end on the CPU (the kernels' plain versions); the port imports without
jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nbody_tpu import config as JC
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.physics.losses import loss_za as j_loss

from nbody_tpu_torch import config as C
from nbody_tpu_torch.cli import train as cli_train
from nbody_tpu_torch.data.dataset import Dataset, features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models.base import params_from_jax
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.train.trainer import (CoverageError, Trainer,
                                           make_optimizer, make_train_step)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = 8
SLICE_MODULES = [
    "nbody_tpu_torch", "nbody_tpu_torch.config", "nbody_tpu_torch.data.grid",
    "nbody_tpu_torch.data.synthetic", "nbody_tpu_torch.data.dataset",
    "nbody_tpu_torch.physics.pbc", "nbody_tpu_torch.physics.losses",
    "nbody_tpu_torch.ops.kernels.build",
    "nbody_tpu_torch.ops.kernels.topk_kernels",
    "nbody_tpu_torch.ops.kernels.banded_kernels",
    "nbody_tpu_torch.ops.kernels.block_kernels",
    "nbody_tpu_torch.ops.kernels.idx_kernels", "nbody_tpu_torch.ops.knn",
    "nbody_tpu_torch.ops.blocked",
    "nbody_tpu_torch.ops.banded", "nbody_tpu_torch.ops.graph_features",
    "nbody_tpu_torch.models.base", "nbody_tpu_torch.models.shiftinv",
    "nbody_tpu_torch.models.registry", "nbody_tpu_torch.train.trainer",
    "nbody_tpu_torch.cli.train"]


def test_adam_steps_track_optax():
    channels, k, lr = (3, 16, 8, 3), 6, 3e-3
    x = features_from_raw(synthetic_raw_cubes(6, CELLS, seed=8))
    batches = [x[2 * i:2 * i + 2] for i in range(3)]
    jmodel = j_build(JC.ModelConfig(family="shiftinv", channels=channels,
                                    k_neighbors=k, knn_window=2,
                                    neighbor_impl="banded"), box=4.0 * CELLS)
    params = jmodel.init(jax.random.PRNGKey(2))
    tmodel = build_model(C.ModelConfig(channels=channels, k_neighbors=k,
                                       knn_window=2), box=4.0 * CELLS)
    tmodel.params = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    step = make_train_step(tmodel, make_optimizer(tmodel, lr))

    opt = optax.adam(lr)

    @jax.jit
    def j_step(p, s, batch):
        val, g = jax.value_and_grad(
            lambda q: j_loss(jmodel.apply(q, batch[..., :6]), batch[..., 6:]))(p)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, val

    state = opt.init(params)
    j_losses, t_losses = [], []
    for batch in batches:
        params, state, val = j_step(params, state, jnp.asarray(batch))
        j_losses.append(float(val))
        tb = torch.from_numpy(batch)
        t_losses.append(float(step(tb[..., :6], tb[..., 6:])))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(
        tmodel.params.W[-1].detach().numpy(), np.asarray(params[-1]["W"]),
        rtol=1e-3, atol=1e-6)


def _cfg(**model):
    return C.Config(
        data=C.DataConfig(data_dir=os.path.join(os.sep, "nonexistent"),
                          num_test=2, num_val=1, cells_per_side=CELLS,
                          synthetic_num_samples=9),
        model=C.ModelConfig(channels=(3, 8, 8, 3), k_neighbors=6,
                            knn_window=2, seed=4, **model),
        train=C.TrainConfig(num_iters=4, batch_size=2, learn_rate=1e-3,
                            checkpoint_every=2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_fit_evaluate_cpu(dtype):
    trainer = Trainer(_cfg(dtype=dtype), "cpu")
    last = trainer.fit(verbose=False)
    assert np.isfinite(last)
    steps = [r for r in trainer.metrics_log if "step" in r]
    assert [r["step"] for r in steps] == [2, 4]
    assert all(r["coverage_margin_violations"] == 0 for r in steps)
    assert trainer.train_error_history == [r["loss"] for r in steps]
    errors, preds = trainer.evaluate(verbose=False)
    assert errors.shape == (1,) and np.isfinite(errors).all()
    assert preds.shape == (2, 2, CELLS ** 3, 3) and np.isfinite(preds).all()
    np.testing.assert_array_equal(preds[0], trainer.dataset.X_test[:2, :, 6:])
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def test_trainer_refuses_uncovered_graph():
    raw = synthetic_raw_cubes(6, CELLS, seed=5)
    raw[..., 1:4] *= 6.0          # displacements far beyond a 1-cell window
    cfg = _cfg()
    cfg = C.Config(cfg.data, C.ModelConfig(channels=(3, 8, 3), k_neighbors=14,
                                           knn_window=1), cfg.train)
    trainer = Trainer(cfg, "cpu", dataset=Dataset(cfg.data, raw=raw))
    with pytest.raises(CoverageError):
        trainer.fit(verbose=False)
    assert trainer.metrics_log[0]["graph_coverage_violations"] > 0


def test_cli_train_cpu(capsys):
    rc = cli_train.main(["--platform", "cpu", "--cells", "8", "-i", "2",
                         "-b", "2", "-t", "2", "--samples", "8", "-k", "6",
                         "--knn_window", "2", "-c", "3", "8", "3",
                         "--synthetic", "--dtype", "bfloat16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Training finished!" in out and "# Test Error" in out
    with pytest.raises(NotImplementedError):
        cli_train.main(["--platform", "cpu", "--scan", "10"])


def test_cuda_platform_needs_a_card():
    if torch.cuda.is_available():
        assert cli_train.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            cli_train.resolve_device("cuda")


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith(('jax.', 'jaxlib')):\n"
        "            raise ImportError('jax is blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py runs for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
