"""Graph-model input featurization (port of nbody_tpu/ops/graph_features.py;
reference get_input_features_shift_inv_ZA, graph.py:289-343, and
include_node_features, graph.py:245-275).

Edges are min-image relative neighbor positions with the ZA displacement on
the self-edge (slot 0).  The reference's deviation fix (min-image offsets
across the periodic boundary instead of box-size jumps) is kept.  Neighbor
access goes through ops/banded.py, whose ``lattice`` / ``masks`` arguments
pick the route (direct, block or masked index).
"""

from __future__ import annotations

from typing import Optional

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


def _cube_cells(n: int) -> int:
    """Cells per side of a full cube of n particles, else 0."""
    cells = int(round(n ** (1.0 / 3.0)))
    return cells if cells ** 3 == n else 0


def _origin_displacement(pos: torch.Tensor, cells: int, box: float) -> torch.Tensor:
    """Min-image displacement of each particle from its origin site."""
    sites = lattice_site_positions(
        torch.arange(pos.shape[-2], dtype=torch.int32, device=pos.device),
        cells, box, pos.dtype)
    return min_image_diff(pos, sites[None], box)


def neighbor_positions(pos: torch.Tensor, idx: torch.Tensor, box: float,
                       lattice=None, masks=None) -> torch.Tensor:
    """Neighbor positions (b, N, K, 3) with bf16-safe magnitudes.

    Gathering absolute coordinates (up to `box`) in bf16 would quantize
    them to ~0.25 units.  As in graph_features.py:45-67, the gathered
    quantity is the min-image DISPLACEMENT from each particle's origin
    site (about a grid spacing), and the neighbor position is rebuilt as
    site(idx) + displacement with exact elementwise arithmetic.  The cube
    must be full (cells^3 particles in grid order)."""
    cells = _cube_cells(pos.shape[-2])
    if not cells:
        raise ValueError(f"neighbor_positions needs a full cells^3 cube, "
                         f"N={pos.shape[-2]}")
    nbr_disp = neighbor_gather(_origin_displacement(pos, cells, box), idx,
                               lattice, masks)
    return lattice_site_positions(idx, cells, box, pos.dtype) + nbr_disp


def edge_features_za(pos: torch.Tensor, idx: torch.Tensor,
                     za_disp: torch.Tensor, box: float, lattice=None,
                     masks=None) -> torch.Tensor:
    """pos (b, N, 3) raw positions, idx (b, N, K) with idx[..., 0] == self,
    za_disp (b, N, 3) -> edges (b, N, K, 3)."""
    nbr = neighbor_positions(pos, idx, box, lattice, masks)
    edges = min_image_diff(nbr, pos[:, :, None, :], box)
    # self-edge (slot 0) carries the ZA displacement (graph.py:338-343)
    return torch.cat([za_disp[:, :, None, :], edges[:, :, 1:, :]], dim=2)


def edge_features_with_nodes(pos: torch.Tensor, idx: torch.Tensor,
                             node_feats: torch.Tensor, box: float,
                             za_disp: Optional[torch.Tensor] = None,
                             lattice=None, masks=None) -> torch.Tensor:
    """Edges + broadcast node features (graph_features.py:84-123):
    (b, N, K, 3 + 2*C_node) = [rel_pos, node[row], node[col]].  With
    za_disp, the self-edge of the rel_pos block carries the ZA
    displacement.  On a full cube one fused gather carries [origin-site
    displacement, node features] (neighbor_positions' bf16-safe form)."""
    cells = _cube_cells(pos.shape[-2])
    if cells:
        payload = torch.cat([_origin_displacement(pos, cells, box), node_feats],
                            dim=-1)
        g = neighbor_gather(payload, idx, lattice, masks)
        nbr = lattice_site_positions(idx, cells, box, pos.dtype) + g[..., :3]
        cols = g[..., 3:]
    else:
        nbr = neighbor_gather(pos, idx)
        cols = neighbor_gather(node_feats, idx)
    edges = min_image_diff(nbr, pos[:, :, None, :], box)
    if za_disp is not None:
        edges = torch.cat([za_disp[:, :, None, :], edges[:, :, 1:, :]], dim=2)
    rows = node_feats[:, :, None, :].expand(*edges.shape[:3], node_feats.shape[-1])
    return torch.cat([edges, rows, cols], dim=-1)
