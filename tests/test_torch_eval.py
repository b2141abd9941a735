"""The eval CLI and its quality leg (nbody_tpu_torch/cli/eval.py,
physics/baseline.py) on the CPU, held against the JAX package.

The baseline helpers equal nbody_tpu/viz/plot_eval.py's (what the JAX
eval CLI calls) on the same f64 arrays to rtol 1e-12, and
nbody_tpu/physics/baseline.py's in f32 to rtol 1e-5 (an f32 lstsq);
train -> eval restores the run and reproduces its test median, as the
JAX test_eval_cli_restores_and_matches holds the JAX CLIs.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from nbody_tpu.physics import baseline as jbase
from nbody_tpu.viz import plot_eval

from nbody_tpu_torch.cli import eval as cli_eval
from nbody_tpu_torch.cli import train as cli_train
from nbody_tpu_torch.physics import baseline


def _snapshots(dtype, shape=(3, 512)):
    rng = np.random.default_rng(11)
    x_in = rng.normal(size=shape + (6,)).astype(dtype)
    x_true = x_in.copy()
    x_true[..., :3] += 0.3 * x_in[..., 3:] + 0.05 * rng.normal(size=shape + (3,))
    return x_in, x_true


def test_baseline_matches_plot_eval_f64():
    x_in, x_true = _snapshots(np.float64)
    t = baseline.calculate_timestep(x_in, x_true)
    np.testing.assert_allclose(t, plot_eval.calculate_timestep(x_in, x_true),
                               rtol=1e-12)
    lin = baseline.get_linear_vel_pred(x_in, t)
    np.testing.assert_allclose(lin, plot_eval.get_linear_vel_pred(x_in, t),
                               rtol=1e-12)
    np.testing.assert_allclose(baseline.l2_dist(lin, x_true[..., :3]),
                               plot_eval.l2_dist(lin, x_true[..., :3]),
                               rtol=1e-12)


def test_baseline_matches_jax_physics_f32():
    x_in, x_true = _snapshots(np.float32, shape=(512,))
    t = baseline.calculate_timestep(x_in, x_true)
    jt = jbase.calculate_timestep(jnp.asarray(x_in), jnp.asarray(x_true))
    np.testing.assert_allclose(t, float(jt), rtol=1e-5)
    lin = baseline.get_linear_vel_pred(x_in, np.float32(t))
    jlin = jbase.linear_velocity_pred(jnp.asarray(x_in), jt)
    np.testing.assert_allclose(lin, np.asarray(jlin), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(baseline.l2_dist(lin, x_true[:, :3]),
                               np.asarray(jbase.l2_dist(jlin, x_true[:, :3])),
                               rtol=1e-5, atol=1e-6)


def test_eval_cli_restores_and_matches(tmp_path, monkeypatch, capsys):
    """Train -> checkpoint -> the eval CLI restores the run at step 6,
    reproduces the train run's test median line, prints and logs the
    linear-velocity baseline comparison; --plot and a missing -n are
    refused."""
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path))
    common = ["--platform", "cpu", "--cells", "8", "-b", "2", "-t", "2",
              "--samples", "8", "-k", "6", "--knn_window", "2",
              "-c", "3", "8", "3", "--synthetic", "-n", "restoretest"]
    assert cli_train.main(["-i", "6", "--scan", "3"] + common) == 0
    out1 = capsys.readouterr().out
    med1 = [ln for ln in out1.splitlines() if "median :" in ln][-1]

    assert cli_eval.main(common) == 0
    out2 = capsys.readouterr().out
    assert "Restored checkpoint at step 6" in out2
    med2 = [ln for ln in out2.splitlines() if "median :" in ln][-1]
    assert med1 == med2
    assert any(ln.startswith("L2 median: model ")
               and "vs linear-velocity baseline" in ln for ln in out2.splitlines())
    with open(tmp_path / "ZA-FPM_0_restoretest" / "metrics.jsonl") as f:
        last = json.loads(f.readlines()[-1])
    assert sorted(last) == ["linear_timestep_fit", "quality_beats_baseline",
                            "quality_linear_median_l2", "quality_model_median_l2"]
    cube = np.load(tmp_path / "ZA-FPM_0_restoretest" / "Results" / "X_0_prediction.npy")
    assert cube.shape == (2, 2, 512, 3)

    with pytest.raises(NotImplementedError,
                       match="nbody_tpu.viz.plot_eval.plot_results_dir"):
        cli_eval.main(common + ["--plot", str(tmp_path / "h.png")])
    with pytest.raises(SystemExit):
        cli_eval.main(common[:-2])
    assert not os.path.exists(tmp_path / "h.png")


def test_quality_leg_matches_the_jax_eval_arithmetic():
    """cli/eval.quality_leg against the JAX eval CLI's arithmetic (through
    plot_eval's helpers) on the same test features and cube."""
    rng = np.random.default_rng(3)
    box = 32.0
    x_test = rng.normal(size=(2, 512, 9)).astype(np.float32)
    cube = rng.normal(size=(2, 2, 512, 3)).astype(np.float32)
    q = cli_eval.quality_leg(x_test, cube, box)
    pos_in = x_test[..., :3] + box / 2.0 + x_test[..., 3:6]
    x_input = np.concatenate([pos_in, x_test[..., 3:6]], axis=-1)
    truth, pred = pos_in + cube[0], pos_in + cube[1]
    t_fit = plot_eval.calculate_timestep(x_input, truth)
    lin = plot_eval.get_linear_vel_pred(x_input, t_fit)
    assert q == {
        "quality_model_median_l2": float(np.median(plot_eval.l2_dist(pred, truth))),
        "quality_linear_median_l2": float(np.median(plot_eval.l2_dist(lin, truth))),
        "linear_timestep_fit": t_fit,
        "quality_beats_baseline": bool(
            np.median(plot_eval.l2_dist(pred, truth))
            < np.median(plot_eval.l2_dist(lin, truth)))}
