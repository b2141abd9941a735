"""Graph-model input featurization (port of nbody_tpu/ops/graph_features.py;
reference get_input_features_shift_inv_ZA, graph.py:289-343).

Edges are min-image relative neighbor positions with the ZA displacement on
the self-edge (slot 0).  The reference's deviation fix (min-image offsets
across the periodic boundary instead of box-size jumps) is kept.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops.banded import neighbor_gather
from nbody_tpu_torch.physics.pbc import min_image_diff


def lattice_site_positions(idx: torch.Tensor, cells: int, box: float,
                           dtype=torch.float32) -> torch.Tensor:
    """Grid-site positions of particle ids, elementwise (no gather):
    particle (i*C + j)*C + k sits at ((i, j, k) + 0.5) * spacing.
    idx (...,) int -> (..., 3) site coordinates in raw units."""
    spacing = box / cells
    x = (idx // (cells * cells)).to(dtype)
    y = ((idx // cells) % cells).to(dtype)
    z = (idx % cells).to(dtype)
    return (torch.stack([x, y, z], dim=-1) + 0.5) * spacing


def neighbor_positions(pos: torch.Tensor, idx: torch.Tensor,
                       box: float) -> torch.Tensor:
    """Neighbor positions (b, N, K, 3) with bf16-safe magnitudes.

    Gathering absolute coordinates (up to `box`) in bf16 would quantize
    them to ~0.25 units.  As in graph_features.py:45-67, the gathered
    quantity is the min-image DISPLACEMENT from each particle's origin
    site (about a grid spacing), and the neighbor position is rebuilt as
    site(idx) + displacement with exact elementwise arithmetic.  The cube
    must be full (cells^3 particles in grid order)."""
    n = pos.shape[-2]
    cells = int(round(n ** (1.0 / 3.0)))
    if cells ** 3 != n:
        raise ValueError(f"neighbor_positions needs a full cells^3 cube, N={n}")
    sites = lattice_site_positions(
        torch.arange(n, dtype=torch.int32, device=pos.device), cells, box,
        pos.dtype)
    disp = min_image_diff(pos, sites[None], box)          # small everywhere
    nbr_disp = neighbor_gather(disp, idx)
    return lattice_site_positions(idx, cells, box, pos.dtype) + nbr_disp


def edge_features_za(pos: torch.Tensor, idx: torch.Tensor,
                     za_disp: torch.Tensor, box: float) -> torch.Tensor:
    """pos (b, N, 3) raw positions, idx (b, N, K) with idx[..., 0] == self,
    za_disp (b, N, 3) -> edges (b, N, K, 3)."""
    nbr = neighbor_positions(pos, idx, box)
    edges = min_image_diff(nbr, pos[:, :, None, :], box)
    # self-edge (slot 0) carries the ZA displacement (graph.py:338-343)
    return torch.cat([za_disp[:, :, None, :], edges[:, :, 1:, :]], dim=2)
