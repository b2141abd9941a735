"""The benchmark's own features of the raw cubes, for the plain reference.

Restated from the reference's assembly of X (evdcush/N-Body_PointCloudEvolution
utils.py:606-619) and its seeded split (utils.py:574-591), not imported
from the program: the reference trains on these, the program on its own
``nbody_tpu_torch.data.dataset`` features of the same raw cubes, so that a
fault in the program's feature preparation shows as a gap.
"""

from __future__ import annotations

import numpy as np

# the reference's split seed (utils.py:574) and the program's default
SPLIT_SEED = 12345


def grid_positions(cells: int, box: float) -> np.ndarray:
    """(C^3, 3) cell centres, x slowest (the reference's meshgrid 'ij')."""
    spacing = box / cells
    axis = (spacing / 2.0 + spacing * np.arange(cells)).astype(np.float32)
    g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def features(raw: np.ndarray) -> np.ndarray:
    """Raw (S, C, C, C, 19) -> (S, N, 9) float32 [grid - box/2, ZA
    displacement, FastPM displacement - ZA displacement], box = 4 C."""
    s, cells = raw.shape[0], raw.shape[1]
    n, box = cells ** 3, 4.0 * cells
    za = raw[..., 1:4].reshape(s, n, 3)
    fpm = raw[..., 7:10].reshape(s, n, 3) - za
    q = np.broadcast_to(grid_positions(cells, box)[None] - box / 2.0, za.shape)
    return np.concatenate([q, za, fpm], axis=-1).astype(np.float32)


def train_rows(num_samples: int, num_test: int, num_val: int,
               seed: int = SPLIT_SEED) -> np.ndarray:
    """The raw cube of each training row: the split's legacy RandomState
    permutation, less its last num_test + num_val."""
    perm = np.random.RandomState(seed).permutation(num_samples)
    return perm[:num_samples - num_test - num_val]
