"""Port parity: the redshift-chain rollout (train/rollout.py) and its CLI
(cli/rollout.py) against the JAX package's, on the same numpy-seeded
inputs with the JAX parameters loaded through params_from_jax.

make_rollout for the set family (64 random particles) and for shiftinv
on an 8^3 cube (K 4, channels (3, 8, 3), 3 hops, with the lattice margin
monitor): trajectory rtol 1e-4 / atol 1e-5 and equal per-hop coverage
counts.  The chain CLI mirrors tests/test_rollout.py:69-99 (set model,
--cells 8 -i 8 -t 2, plain and --scan 4); its two linear-baseline
columns depend on the data alone and equal the JAX CLI's to rtol 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.cli import rollout as j_cli
from nbody_tpu.data.dataset import features_from_raw
from nbody_tpu.data.synthetic import synthetic_raw_cubes
from nbody_tpu.models.registry import build_model as j_build
from nbody_tpu.ops.knn import lattice_violations as j_violations
from nbody_tpu.train import rollout as j_rollout

from nbody_tpu_torch import config as C
from nbody_tpu_torch.cli import rollout as t_cli
from nbody_tpu_torch.models.base import params_from_jax
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops.knn import lattice_violations
from nbody_tpu_torch.train.rollout import (make_rollout, rollout_mse,
                                           stack_params)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CELLS = 8
BOX = 4.0 * CELLS


def _models(family, channels, steps, **model):
    """The JAX model, its stacked params, and the port model with the same
    params stacked on the step axis."""
    jmodel = j_build(JC.ModelConfig(family=family, channels=channels, seed=0,
                                    **model), box=BOX)
    jparams = [jmodel.init(jax.random.PRNGKey(s)) for s in range(steps)]
    tmodel = build_model(C.ModelConfig(family=family, channels=channels,
                                       seed=0, **{k: v for k, v in model.items()
                                                  if k != "neighbor_impl"}),
                         box=BOX, device="cpu")
    seq = []
    for p in jparams:
        tmodel.params = params_from_jax(jax.tree_util.tree_map(np.asarray, p))
        seq.append(dict(tmodel.named_parameters()))
    return jmodel, j_rollout.stack_params(jparams), tmodel, stack_params(seq)


def test_set_rollout_matches_jax():
    """64 random particles in a 32-box, 4 hops: the trajectory, and
    rollout_mse against a perturbed truth."""
    jmodel, jstacked, tmodel, tstacked = _models("set", (6, 16, 3), 4)
    rng = np.random.default_rng(0)
    q = rng.uniform(-16, 16, (2, 64, 3)).astype(np.float32)
    disp = 0.1 * rng.normal(size=(2, 64, 3)).astype(np.float32)
    x0 = np.concatenate([q, disp], -1)
    jfinal, jtraj = j_rollout.make_rollout(jmodel)(jstacked, jnp.asarray(x0))
    final, traj = make_rollout(tmodel)(tstacked, torch.from_numpy(x0))
    assert traj.shape == (4, 2, 64, 3) and torch.equal(final, traj[-1])
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-4,
                               atol=1e-5)
    truth = np.asarray(jtraj) + 0.01 * rng.normal(size=jtraj.shape).astype(np.float32)
    np.testing.assert_allclose(
        rollout_mse(tmodel, tstacked, torch.from_numpy(x0),
                    torch.from_numpy(truth)).numpy(),
        np.asarray(j_rollout.rollout_mse(jmodel, jstacked, jnp.asarray(x0),
                                         jnp.asarray(truth))), rtol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_shiftinv_rollout_matches_jax(scale):
    """An 8^3 cube, K 4, window 2, 3 hops, with the margin monitor on every
    hop's input: the trajectory and the per-hop counts.  At 4x the ZA
    displacement the monitor trips."""
    jmodel, jstacked, tmodel, tstacked = _models(
        "shiftinv", (3, 8, 3), 3, k_neighbors=4, knn_window=2,
        neighbor_impl="banded")
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=0))[..., :6]
    x0 = np.ascontiguousarray(x).copy()
    x0[..., 3:6] *= scale

    def j_cov(x_in):
        pos = x_in[..., :3] + BOX / 2.0 + x_in[..., 3:6]
        return j_violations(pos, CELLS, box=BOX, window=2)

    def t_cov(x_in):
        pos = x_in[..., :3] + BOX / 2.0 + x_in[..., 3:6]
        return lattice_violations(pos, CELLS, box=BOX, window=2)

    _, (jtraj, jcounts) = j_rollout.make_rollout(jmodel, coverage_fn=j_cov)(
        jstacked, jnp.asarray(x0))
    _, (traj, counts) = make_rollout(tmodel, coverage_fn=t_cov)(
        tstacked, torch.from_numpy(x0))
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.shape == (3,) and (int(counts[0]) > 0) == (scale > 1)


def test_rollout_refuses_the_velocity_family(tmp_path, monkeypatch):
    model = build_model(C.ModelConfig(family="shiftinv_vel"), device="cpu")
    with pytest.raises(ValueError, match="shiftinv_vel"):
        make_rollout(model)
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="shiftinv_vel"):
        t_cli.main(["--platform", "cpu", "--velocity", "--cells", "8",
                    "--synthetic", "-i", "1"])


CHAIN_FLAGS = ["--steps", "2", "-i", "8", "-b", "2", "-t", "2", "--cells", "8",
               "--synthetic", "-n", "chaintest", "--model", "set",
               "-c", "6", "8", "3", "-l", "0.003"]


def _last_json(out):
    return json.loads([ln for ln in out.strip().splitlines()
                       if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def jax_chain(tmp_path_factory):
    """The JAX chain CLI's summary for CHAIN_FLAGS (run once)."""
    import contextlib
    import io
    import os
    old = os.environ.get("NBODY_EXPERIMENTS_DIR")
    os.environ["NBODY_EXPERIMENTS_DIR"] = str(tmp_path_factory.mktemp("jax"))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            assert j_cli.main(CHAIN_FLAGS) == 0
    finally:
        if old is None:
            os.environ.pop("NBODY_EXPERIMENTS_DIR")
        else:
            os.environ["NBODY_EXPERIMENTS_DIR"] = old
    return _last_json(buf.getvalue())


@pytest.mark.parametrize("scan_args", [[], ["--scan", "4"]],
                         ids=["plain", "scan"])
def test_chain_cli_end_to_end(tmp_path, monkeypatch, capsys, scan_args,
                              jax_chain):
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path / "exp"))
    assert t_cli.main(CHAIN_FLAGS + ["--platform", "cpu"] + scan_args) == 0
    out = capsys.readouterr().out
    assert "Rollout per chain step" in out
    rec = _last_json(out)
    assert set(rec) == set(jax_chain)
    assert np.isfinite(rec["rollout_final_mse"])
    assert len(rec["rollout_model_median_l2"]) == 2
    assert all(np.isfinite(v) for v in rec["rollout_model_median_l2"])
    lin, lin_chain = (rec["rollout_linear_median_l2"],
                      rec["rollout_linear_chain_median_l2"])
    assert len(lin) == len(lin_chain) == 2
    assert abs(lin_chain[0] - lin[0]) < 1e-6
    assert lin_chain[1] >= lin[1] - 1e-6
    for key in ("rollout_linear_median_l2", "rollout_linear_chain_median_l2"):
        np.testing.assert_allclose(rec[key], jax_chain[key], rtol=1e-5)
    cube = np.load(tmp_path / "exp" / "ZA-FPM_0_chaintest" / "Results" /
                   "X_0_prediction.npy")
    assert cube.shape == (2, 2, 2, CELLS ** 3, 3)
    metrics = [json.loads(ln) for ln in open(
        tmp_path / "exp" / "ZA-FPM_0_chaintest" / "metrics.jsonl")]
    assert metrics[-1]["steps"] == 2 and "coverage_margin_violations" not in metrics[-1]


def test_chain_cli_monitors_the_graph_family(tmp_path, monkeypatch, capsys):
    """shiftinv on the chain: each pair's Trainer runs the coverage guard,
    and the rollout records its per-hop margin counts."""
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path))
    assert t_cli.main(["--platform", "cpu", "--steps", "2", "-i", "2", "-b",
                       "2", "-t", "2", "--cells", "8", "--synthetic", "-k",
                       "4", "--knn_window", "2", "-c", "3", "8", "3", "-n",
                       "g"]) == 0
    metrics = [json.loads(ln) for ln in open(tmp_path / "ZA-FPM_0_g" /
                                             "metrics.jsonl")]
    assert len(metrics[-1]["coverage_margin_violations"]) == 2
    assert np.isfinite(_last_json(capsys.readouterr().out)["rollout_final_mse"])
