"""Linear-velocity comparison baseline, numpy on the host (port of
nbody_tpu/physics/baseline.py and of the helpers of
nbody_tpu/viz/plot_eval.py that the eval CLI calls; reference
plot_eval.py:85-96).

The reference judges a model against a trivial predictor: advance the
input positions by one least-squares-fit timestep of the input velocity.
The eval CLI's quality leg (cli/eval.py) compares the median per-particle
L2 distance of the model and of this baseline to the truth.
"""

from __future__ import annotations

import numpy as np


def calculate_timestep(x_in: np.ndarray, x_true: np.ndarray) -> float:
    """Least-squares timestep fit t: ||vel * t - dpos|| min (reference
    plot_eval.py:85-88).  x_in (..., 6) [pos, vel], x_true (..., >= 3)."""
    diff = (x_true[..., :3] - x_in[..., :3]).reshape(-1)
    vel = x_in[..., 3:].reshape(-1, 1)
    t, *_ = np.linalg.lstsq(vel, diff, rcond=None)
    return float(t[0])


def get_linear_vel_pred(x_in: np.ndarray, timestep: float) -> np.ndarray:
    """pos + t * vel (reference get_linearVel_pred, plot_eval.py:90-93)."""
    return x_in[..., :3] + timestep * x_in[..., 3:]


def l2_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-particle L2 distance (reference l2_dist, plot_eval.py:95-96)."""
    return np.sqrt(np.sum(np.square(a - b), axis=-1))
