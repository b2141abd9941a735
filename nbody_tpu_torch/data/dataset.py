"""Dataset loading, feature extraction, seeded splits, batching (port of
nbody_tpu/data/dataset.py; reference twin utils.py:547-621).

Deviation from the JAX package, by necessity: minibatch sampling draws
from a ``np.random.Generator`` seeded with ``DataConfig.seed`` instead of
``jax.random`` keys, whose threefry streams cannot be reproduced without
jax.  Features and the train/val/test split are bit-identical to the JAX
package's.  The streaming (mmap) dataset is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.grid import grid_positions_np
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes


def load_cube_file(path: str) -> np.ndarray:
    """np.load a raw (S, C, C, C, 19) cube file."""
    return np.load(path)


def features_from_raw(raw: np.ndarray, include_velocity: bool = False) -> np.ndarray:
    """Raw (S, C, C, C, 19) -> (S, N, 9) features
    [q - box/2 (3), za_disp (3), fpm_disp - za_disp (3)], exactly as the
    reference assembles X (utils.py:606-619).

    include_velocity=True -> (S, N, 15): inputs [q - box/2, za_disp,
    za_vel] (9) and targets [fpm_disp - za_disp, fpm_vel - za_vel] (6),
    the joint position+velocity task (data/dataset.py:32-57)."""
    s, cx, cy, cz, _ = raw.shape
    if not cx == cy == cz:
        raise ValueError(f"cubes must be cubic, got {raw.shape[1:4]}")
    n = cx * cy * cz
    box = 4.0 * cx  # real data: 32 cells, box 128
    za = raw[..., C.COL_ZA_DISP].reshape(s, n, 3)
    fpm = raw[..., C.COL_FPM_DISP].reshape(s, n, 3) - za
    q = grid_positions_np(cx, box=box)
    q_centered = np.broadcast_to(q[None] - box / 2.0, za.shape)
    if not include_velocity:
        return np.concatenate([q_centered, za, fpm], axis=-1).astype(np.float32)
    za_vel = raw[..., C.COL_ZA_VEL].reshape(s, n, 3)
    fpm_vel = raw[..., C.COL_FPM_VEL].reshape(s, n, 3) - za_vel
    return np.concatenate([q_centered, za, za_vel, fpm, fpm_vel],
                          axis=-1).astype(np.float32)


def split_dataset(x: np.ndarray, num_test: int, num_val: int = C.NUM_VAL_SAMPLES,
                  seed: int = C.DATASET_SEED):
    """Seeded permutation split -> (train, val, test), bit-identical to the
    reference (utils.py:574-591): legacy RandomState permutation."""
    rs = np.random.RandomState(seed)
    rnd_idx = rs.permutation(x.shape[0])
    split_idx = [-num_test - num_val, -num_test]
    return np.split(x[rnd_idx], split_idx, axis=0)


def split_batch(batch, num_inputs: int = 6):
    """(b, N, 9) -> inputs [q-64, za], target residual (reference
    train.py:95-96); (b, N, 15) with num_inputs=9 for the velocity task.
    Works on numpy arrays and torch tensors."""
    return batch[..., :num_inputs], batch[..., num_inputs:]


class Dataset:
    """Train/val/test feature arrays (S_i, N, 9), or (S_i, N, 15) with
    velocities, and batching."""

    def __init__(self, cfg: Optional[C.DataConfig] = None,
                 raw: Optional[np.ndarray] = None):
        cfg = cfg or C.DataConfig()
        self.cfg = cfg
        if raw is None:
            raw = self._load_raw(cfg)
        self.cells = raw.shape[1]
        self.box = 4.0 * self.cells
        self.num_input_channels = 9 if cfg.include_velocity else 6
        x = features_from_raw(raw, include_velocity=cfg.include_velocity)
        num_test = min(cfg.num_test, max(1, x.shape[0] - cfg.num_val - 2))
        num_val = min(cfg.num_val, max(1, x.shape[0] - num_test - 1))
        self.X_train, self.X_val, self.X_test = split_dataset(
            x, num_test, num_val, cfg.seed)

    @staticmethod
    def _load_raw(cfg: C.DataConfig) -> np.ndarray:
        paths = sorted(glob.glob(os.path.join(cfg.data_dir, "*.npy")))
        if paths:
            if not 0 <= cfg.data_idx < len(paths):
                raise IndexError(
                    f"data_idx {cfg.data_idx} out of range: {len(paths)} "
                    f"dataset files in {cfg.data_dir}")
            return load_cube_file(paths[cfg.data_idx])
        print(f"No .npy cubes in {cfg.data_dir} — generating synthetic data "
              f"({cfg.synthetic_num_samples} x {cfg.cells_per_side}^3).")
        return synthetic_raw_cubes(
            num_samples=cfg.synthetic_num_samples, cells=cfg.cells_per_side,
            seed=cfg.seed)

    @property
    def num_particles(self) -> int:
        return self.X_train.shape[1]

    def minibatch_rng(self) -> np.random.Generator:
        """The minibatch stream of a training run, seeded from the data
        seed (the JAX trainer's PRNGKey(data.seed) counterpart)."""
        return np.random.default_rng(self.cfg.seed)

    def get_minibatch_indices(self, rng: np.random.Generator,
                              batch_size: int = C.BATCH_SIZE) -> np.ndarray:
        """Indices of one minibatch, sampled without replacement."""
        return rng.choice(self.X_train.shape[0], batch_size, replace=False)

    def get_minibatch(self, rng: np.random.Generator,
                      batch_size: int = C.BATCH_SIZE) -> np.ndarray:
        """Random minibatch without replacement (reference utils.py:559-566)."""
        return self.X_train[self.get_minibatch_indices(rng, batch_size)]

    def sequential_batches(self, split: str, batch_size: int):
        """Yield (start, batch) slices over a split (reference train.py:140-151)."""
        x = {"val": self.X_val, "test": self.X_test, "train": self.X_train}[split]
        for j in range(x.shape[0] // batch_size):
            p = batch_size * j
            yield p, x[p:p + batch_size]


def make_dataset(cfg: Optional[C.DataConfig] = None) -> Dataset:
    """Dataset factory: real cubes from cfg.data_dir, else synthetic."""
    return Dataset(cfg or C.DataConfig())
