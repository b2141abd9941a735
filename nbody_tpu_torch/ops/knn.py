"""Periodic k-nearest-neighbor search (port of nbody_tpu/ops/knn.py).

``knn_periodic_lattice_batch`` is the main path's in-step graph build:
kernel A's lattice_knn (ops/kernels/topk_kernels.py) scores the (2w+1)^3
lattice candidates with the same expression tree as the JAX package (so
near-ties break the same way) and keeps the k nearest.
``knn_periodic`` is the exact O(N^2) search, plain PyTorch; it is only the
coverage oracle.

Slot 0 is always the particle itself (its distance is forced below all
others), which the featurizer relies on.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.data.grid import grid_positions
from nbody_tpu_torch.ops.kernels.topk_kernels import lattice_knn
from nbody_tpu_torch.physics.pbc import min_image_diff


def pairwise_min_image_sq_dist(x: torch.Tensor, y: torch.Tensor,
                               box: float = 1.0) -> torch.Tensor:
    """(n, 3) x (m, 3) -> (n, m) squared min-image distances, summed over
    the dims in order from zero as ops/knn.py:32-39 does."""
    d2 = torch.zeros((x.shape[0], y.shape[0]), dtype=x.dtype, device=x.device)
    for dim in range(x.shape[-1]):
        delta = min_image_diff(x[:, dim:dim + 1], y[None, :, dim], box)
        d2 = d2 + delta * delta
    return d2


@torch.no_grad()
def knn_periodic(pos: torch.Tensor, k: int, box: float = 1.0,
                 row_chunk: int = 512) -> torch.Tensor:
    """Exact kNN under periodic boundaries: pos (N, 3) -> (N, k) int32.

    Every pair is examined in row chunks; selection is a stable ascending
    sort (lax.top_k(-d2) order: ties to the lowest column)."""
    n = pos.shape[0]
    out = []
    for r0 in range(0, n, row_chunk):
        rows = pos[r0:r0 + row_chunk]
        d2 = pairwise_min_image_sq_dist(rows, pos, box)
        ids = torch.arange(r0, r0 + rows.shape[0], device=pos.device)
        is_self = torch.arange(n, device=pos.device)[None, :] == ids[:, None]
        d2 = torch.where(is_self, -1.0, d2)
        out.append(torch.sort(d2, dim=-1, stable=True).indices[:, :k])
    return torch.cat(out).to(torch.int32)


def knn_periodic_batch(pos: torch.Tensor, k: int, box: float = 1.0,
                       row_chunk: int = 512) -> torch.Tensor:
    """Batched exact kNN: pos (b, N, 3) -> (b, N, k)."""
    return torch.stack([knn_periodic(p, k, box, row_chunk) for p in pos])


def knn_periodic_lattice_batch(pos: torch.Tensor, k: int, cells: int,
                               box: float = 1.0, window: int = 3) -> torch.Tensor:
    """Cell-list kNN for grid-ordered cubes: pos (b, N, 3) -> (b, N, k) int32.

    Particle n originates at lattice site unflatten(n); its candidates are
    the (2w+1)^3 sites around it (the rolls of the position cube), exact
    while every displacement stays inside the window (the coverage guard
    verifies it).  Mirrors ops/knn.py:173-239 step by step -- the clamped
    window, the lexicographic roll order, min_image_diff(cands, pos)
    summed over xyz, the self slot set to -1, the lowest-slot tie rule,
    the slot decode with per-axis wrap -- in one launch of kernel A's
    lattice_knn (ops/kernels/topk_kernels.py).
    """
    return lattice_knn(pos, k, cells, window, box)


def knn_periodic_lattice(pos: torch.Tensor, k: int, cells: int,
                         box: float = 1.0, window: int = 3) -> torch.Tensor:
    """One cube: pos (N, 3) -> (N, k) int32 (see knn_periodic_lattice_batch)."""
    return knn_periodic_lattice_batch(pos[None], k, cells, box, window)[0]


def lattice_violations(pos: torch.Tensor, cells: int, box: float = 1.0,
                       window: int = 3) -> torch.Tensor:
    """Count particles displaced further than the lattice window can see
    (window - 1 spacings, a conservative margin); nonzero means the lattice
    search may miss true neighbors of those rows."""
    spacing = box / cells
    sites = grid_positions(cells, box=box, dtype=pos.dtype, device=pos.device)
    d = min_image_diff(pos, sites, box)
    return torch.sum(torch.any(torch.abs(d) > (window - 1) * spacing, dim=-1))
