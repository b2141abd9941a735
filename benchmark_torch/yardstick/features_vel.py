"""The benchmark's own features of the raw cubes for the joint
position+velocity task, for the plain reference.

Restated from the reference's 19-column schema (evdcush/N-Body_PointCloudEvolution
utils.py:530-545: ZA displacement 1:4, FastPM displacement 7:10, ZA
velocity 10:13, FastPM velocity 16:19) and its assembly of X with
velocities (utils.py:606-619), not imported from the program: the
reference trains on these, the program on its own
``Dataset(include_velocity=True)`` features of the same raw cubes.  The
grid positions and the training split are yardstick/features.py's.
"""

from __future__ import annotations

import numpy as np

from benchmark_torch.yardstick.features import grid_positions


def features(raw: np.ndarray) -> np.ndarray:
    """Raw (S, C, C, C, 19) -> (S, N, 15) float32: inputs [grid - box/2,
    ZA displacement, ZA velocity] and targets [FastPM - ZA displacement,
    FastPM - ZA velocity], box = 4 C."""
    s, cells = raw.shape[0], raw.shape[1]
    n, box = cells ** 3, 4.0 * cells

    def cols(lo):
        return raw[..., lo:lo + 3].reshape(s, n, 3)

    za, za_vel = cols(1), cols(10)
    q = np.broadcast_to(grid_positions(cells, box)[None] - box / 2.0, za.shape)
    return np.concatenate([q, za, za_vel, cols(7) - za, cols(16) - za_vel],
                          axis=-1).astype(np.float32)
