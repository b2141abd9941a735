"""Periodic k-nearest-neighbor search (port of nbody_tpu/ops/knn.py).

``knn_periodic_lattice_batch`` is the main path's in-step graph build:
kernel A's lattice_knn (ops/kernels/topk_kernels.py) scores the (2w+1)^3
lattice candidates with the same expression tree as the JAX package (so
near-ties break the same way) and keeps the k nearest.
``knn_periodic`` is the pairwise search, plain PyTorch (the JAX package
runs it outside any Pallas kernel): exact over every pair, or with
``band=`` over the circular index slab around each row chunk
(ops/knn.py:58-134).  It is the coverage oracle, the in-step search of
``knn_method`` "banded" and "exact", and the fallback on point sets that
are not a full cube.

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


# distances a banded search scores at once (a group of row chunks)
_BANDED_GROUP_ELEMS = 1 << 24


def _smallest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Lanes of the k smallest entries of each row, ascending, ties to the
    lowest lane: the order of lax.top_k(-d2, k), by a stable sort."""
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


@torch.no_grad()
def knn_periodic(pos: torch.Tensor, k: int, box: float = 1.0,
                 row_chunk: int = 512, band: int = None) -> torch.Tensor:
    """kNN under periodic boundaries: pos (N, 3) -> (N, k) int32, self at
    slot 0.

    band=None: exact, every pair examined in row chunks.  band=int: the
    candidates of a row chunk are the circular slab of chunk + 2*(band//2)
    ids around it, as ops/knn.py:58-134 searches them, with the same
    fallback to the exact search where no banded layout exists."""
    n = pos.shape[0]
    if band is not None and _banded_chunk(n, band) is not None:
        return _knn_periodic_banded(pos[None], k, box, band)[0]
    out = []
    for r0 in range(0, n, row_chunk):
        rows = pos[r0:r0 + row_chunk]
        d2 = pairwise_min_image_sq_dist(rows, pos, box)
        ids = torch.arange(r0, r0 + rows.shape[0], device=pos.device)
        is_self = torch.arange(n, device=pos.device)[None, :] == ids[:, None]
        d2 = torch.where(is_self, -1.0, d2)
        out.append(_smallest_k(d2, k))
    return torch.cat(out).to(torch.int32)


def _banded_chunk(n: int, band: int):
    """Largest row chunk with chunk + band <= n (so the circular slab never
    repeats a candidate) that divides n; None if no banded layout exists,
    which is exactly when band >= n."""
    for c in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if c + band <= n and n % c == 0:
            return c
    return None


@torch.no_grad()
def _knn_periodic_banded(pos: torch.Tensor, k: int, box: float,
                         band: int) -> torch.Tensor:
    """Banded kNN of a batch, pos (b, N, 3) -> (b, N, k) int32.

    Chunk t's slab is pos_pad[t0 : t0 + slab] of the circularly padded
    cube: slab position p is the id (t0 - half + p) mod N.  The selection
    runs over slab positions, so ties break to the lowest slab position
    as lax.top_k does there (not always the lowest id: the slab wraps),
    and the positions map to ids afterwards (ops/knn.py:130-131).  Groups
    of chunks are scored at once; the distances are the same expression
    tree as the exact search's (pairwise_min_image_sq_dist)."""
    b, n, _ = pos.shape
    chunk = _banded_chunk(n, band)
    half = band // 2
    slab = chunk + 2 * half
    num_chunks = n // chunk
    dev = pos.device
    pos_pad = torch.cat([pos[:, n - half:], pos, pos[:, :half]], dim=1)
    lane = torch.arange(slab, device=dev)
    local_self = torch.arange(chunk, device=dev)[:, None] + half
    is_self = lane[None, :] == local_self                  # (chunk, slab)
    group = max(1, _BANDED_GROUP_ELEMS // (b * chunk * slab))
    out = []
    for g0 in range(0, num_chunks, group):
        ts = torch.arange(g0, min(g0 + group, num_chunks), device=dev)
        t0 = ts * chunk
        rows = pos.reshape(b, num_chunks, chunk, 3)[:, g0:g0 + ts.numel()]
        cand = pos_pad[:, t0[:, None] + lane[None, :]]     # (b, G, slab, 3)
        d2 = torch.zeros(rows.shape[:3] + (slab,), dtype=pos.dtype, device=dev)
        for dim in range(3):
            delta = min_image_diff(rows[..., dim:dim + 1],
                                   cand[:, :, None, :, dim], box)
            d2 = d2 + delta * delta
        d2 = torch.where(is_self, -1.0, d2)
        local = _smallest_k(d2, k)                         # slab positions
        ids = torch.remainder(local + (t0 - half)[None, :, None, None], n)
        out.append(ids.reshape(b, -1, k))
    return torch.cat(out, dim=1).to(torch.int32)


def knn_periodic_batch(pos: torch.Tensor, k: int, box: float = 1.0,
                       row_chunk: int = 512, band: int = None) -> torch.Tensor:
    """Batched kNN: pos (b, N, 3) -> (b, N, k) int32 (see knn_periodic)."""
    n = pos.shape[1]
    if band is not None and _banded_chunk(n, band) is not None:
        return _knn_periodic_banded(pos, k, box, band)
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
