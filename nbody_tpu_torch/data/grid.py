"""Uniform Lagrangian grid generation (port of nbody_tpu/data/grid.py).

Particle p = (i*C + j)*C + k sits at the cell center
(spacing/2 + spacing*i, ..., ...) with spacing = box/C, the reference's
ordering (reference utils.py:611-613, nn.py:183-189).
"""

from __future__ import annotations

import numpy as np
import torch


def grid_positions_np(cells_per_side: int = 32, box: float = 128.0,
                      dtype=np.float32) -> np.ndarray:
    """(C^3, 3) cell-center grid, ordering identical to the reference."""
    spacing = box / cells_per_side
    axis = (spacing / 2.0 + spacing * np.arange(cells_per_side)).astype(dtype)
    g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def grid_positions(cells_per_side: int = 32, box: float = 128.0,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Torch twin of :func:`grid_positions_np`, built on `device`."""
    spacing = box / cells_per_side
    axis = spacing / 2.0 + spacing * torch.arange(
        cells_per_side, dtype=dtype, device=device)
    g = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1)
    return g.reshape(-1, 3)
