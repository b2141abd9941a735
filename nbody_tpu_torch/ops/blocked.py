"""3D-block gather/scatter for lattice kNN graphs (port of
nbody_tpu/ops/blocked.py).

Every neighbor of a particle in a (bx, by, bz) core block lies inside the
block's dilated patch of P = (bx+2w)(by+2w)(bz+2w) lattice sites (w the
lattice window).  A neighbor op then becomes, per block, a selection
against the patch by a per-edge position in [0, P):

  cube_to_blocks / blocks_to_cube   reshapes + permutes between the z-major
                                    cube order and block-major order;
  block_patches                     the dilated patches, strided views of
                                    the circularly padded cube (one copy);
  edge_block_positions              each edge's neighbor as a position in
                                    its block's patch (integer arithmetic);
  kernels D/E (ops/kernels/idx_kernels.py, the index route of the masked
  path) or F/G (ops/kernels/block_kernels.py, ``--impl block``)
                                    the per-block selection and its sum;
  patches_fold                      the transpose of block_patches: the
                                    per-block (P, C) sums overlap-added
                                    back into the cube, in f32.

Requires N == cells^3 in grid order and |offset| <= window per axis, which
the lattice kNN guarantees.  The core shape travels as an argument; the
JAX module's default cores are the two constants below (its set_core
globals and the one-hot ``block_masks`` encoding are not ported).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from nbody_tpu_torch.ops.kernels import block_kernels as BK
from nbody_tpu_torch.ops.kernels.idx_kernels import idx_dot_gather, idx_dot_scatter

# default core of the --impl block route
CORE = (4, 4, 8)
# default (first-choice) core of the masked index route
MASKED_CORE = (4, 8, 8)

Core = Tuple[int, int, int]


def lattice_core(lattice) -> Core:
    """Core carried by a lattice tuple (cells, window[, core[, self_free]]);
    2-tuples fall back to MASKED_CORE."""
    if lattice is not None and len(lattice) > 2 and lattice[2]:
        return tuple(lattice[2])
    return MASKED_CORE


def lattice_self_free(lattice) -> bool:
    """Whether the positions were built with the self slot dropped
    (block_positions drop_self_slot0=True): slot 0 of every edge row is the
    particle itself, an identity copy outside the kernels."""
    return lattice is not None and len(lattice) > 3 and bool(lattice[3])


def block_geometry(cells: int, window: int, core: Sequence[int]):
    """-> ((nbx, nby, nbz) blocks per axis, (ex, ey, ez) patch extents)."""
    bx, by, bz = core
    if cells % bx or cells % by or cells % bz:
        raise ValueError(f"core {tuple(core)} does not tile a {cells}^3 cube")
    nb = (cells // bx, cells // by, cells // bz)
    ext = (bx + 2 * window, by + 2 * window, bz + 2 * window)
    return nb, ext


def patch_size(cells: int, window: int, core: Sequence[int]) -> int:
    _, (ex, ey, ez) = block_geometry(cells, window, core)
    return ex * ey * ez


def cube_to_blocks(values: torch.Tensor, cells: int,
                   core: Sequence[int]) -> torch.Tensor:
    """(B, N, C) z-major -> (B, NB, R, C) block-major."""
    b, _, c = values.shape
    bx, by, bz = core
    v = values.reshape(b, cells // bx, bx, cells // by, by, cells // bz, bz, c)
    v = v.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return v.reshape(b, -1, bx * by * bz, c)


def blocks_to_cube(blocks: torch.Tensor, cells: int,
                   core: Sequence[int]) -> torch.Tensor:
    """(B, NB, R, C) block-major -> (B, N, C) z-major."""
    b, _, _, c = blocks.shape
    bx, by, bz = core
    v = blocks.reshape(b, cells // bx, cells // by, cells // bz, bx, by, bz, c)
    v = v.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return v.reshape(b, cells ** 3, c)


def _wrap_pad(grid: torch.Tensor, w: int) -> torch.Tensor:
    """(B, c, c, c, C) -> circularly padded (B, c+2w, c+2w, c+2w, C)
    (jnp.pad mode="wrap")."""
    cells = grid.shape[1]
    ids = torch.remainder(torch.arange(-w, cells + w, device=grid.device), cells)
    for axis in (1, 2, 3):
        grid = grid.index_select(axis, ids)
    return grid


def _block_patches(values: torch.Tensor, cells: int, window: int,
                   core: Sequence[int]) -> torch.Tensor:
    b, _, c = values.shape
    bx, by, bz = core
    (nbx, nby, nbz), (ex, ey, ez) = block_geometry(cells, window, core)
    padded = _wrap_pad(values.reshape(b, cells, cells, cells, c), window)
    u = padded.unfold(1, ex, bx).unfold(2, ey, by).unfold(3, ez, bz)
    # (B, nbx, nby, nbz, C, ex, ey, ez) -> (B, nbx, nby, nbz, ex, ey, ez, C)
    u = u.permute(0, 1, 2, 3, 5, 6, 7, 4)
    return u.reshape(b, nbx * nby * nbz, ex * ey * ez, c)


def _patches_fold(acc: torch.Tensor, cells: int, window: int,
                  core: Sequence[int]) -> torch.Tensor:
    b, _, _, c = acc.shape
    bx, by, bz = core
    (nbx, nby, nbz), (ex, ey, ez) = block_geometry(cells, window, core)
    w = window
    pc = cells + 2 * w
    a = acc.reshape(b, nbx, nby, nbz, ex, ey, ez, c)
    a = a.permute(0, 1, 4, 2, 5, 3, 6, 7)       # (B, nbx, ex, nby, ey, nbz, ez, C)
    rows_z = b * nbx * ex * nby * ey
    a3 = a.reshape(rows_z, nbz, ez, c)
    az = acc.new_zeros((rows_z, pc, c))
    for lz in range(ez):
        az[:, lz:lz + nbz * bz:bz] += a3[:, :, lz]
    rows_y = b * nbx * ex
    a4 = az.reshape(rows_y, nby, ey, pc * c)
    ay = acc.new_zeros((rows_y, pc, pc * c))
    for ly in range(ey):
        ay[:, ly:ly + nby * by:by] += a4[:, :, ly]
    a5 = ay.reshape(b, nbx, ex, pc * pc * c)
    out = acc.new_zeros((b, pc, pc * pc * c))
    for lx in range(ex):
        out[:, lx:lx + nbx * bx:bx] += a5[:, :, lx]
    out = out.reshape(b, pc, pc, pc, c)
    # padded coords [0, w) belong to [cells-w, cells), [w+cells, cells+2w)
    # to [0, w)
    for axis in (1, 2, 3):
        core_part = out.narrow(axis, w, cells).clone()
        core_part.narrow(axis, cells - w, w).add_(out.narrow(axis, 0, w))
        core_part.narrow(axis, 0, w).add_(out.narrow(axis, w + cells, w))
        out = core_part
    return out.reshape(b, cells ** 3, c)


class _BlockPatches(torch.autograd.Function):
    """block_patches with patches_fold as its gradient, in the cotangent's
    dtype: JAX transposes block_patches in the patches' dtype, in the same
    order of adds."""

    @staticmethod
    def forward(ctx, values, cells, window, core):
        ctx.geom = (cells, window, core)
        return _block_patches(values, cells, window, core)

    @staticmethod
    def backward(ctx, ct):
        return _patches_fold(ct, *ctx.geom), None, None, None


class _PatchesFold(torch.autograd.Function):
    """patches_fold with block_patches as its gradient."""

    @staticmethod
    def forward(ctx, acc, cells, window, core):
        ctx.geom = (cells, window, core)
        return _patches_fold(acc, cells, window, core)

    @staticmethod
    def backward(ctx, ct):
        return _block_patches(ct, *ctx.geom), None, None, None


def block_patches(values: torch.Tensor, cells: int, window: int,
                  core: Sequence[int]) -> torch.Tensor:
    """(B, N, C) -> (B, NB, P, C): each core block's dilated patch, in
    (lx, ly, lz) order.  The windows are strided views (unfold) of the
    padded cube; the final reshape is the one copy.  Its gradient is
    patches_fold (an autograd pair, so autograd records no slice ops)."""
    return _BlockPatches.apply(values, cells, window, tuple(core))


def patches_fold(acc: torch.Tensor, cells: int, window: int,
                 core: Sequence[int]) -> torch.Tensor:
    """(B, NB, P, C) per-block sums -> (B, N, C): the exact transpose of
    block_patches, with the JAX package's order of adds (z, then y, then x
    strided slice-adds into the padded cube, then the pad rings folded
    back axis by axis), so f32 sums are bit-equal to it.  Its gradient is
    block_patches."""
    return _PatchesFold.apply(acc, cells, window, tuple(core))


def edge_block_positions(idx: torch.Tensor, cells: int, window: int,
                         core: Sequence[int]) -> torch.Tensor:
    """(B, N, K) neighbor ids -> (B, NB, R*K) int32 positions within each
    core block's dilated patch (block-major edge order).  Offsets wrap by
    floor-mod (torch.remainder, as jnp.mod), never a truncating %."""
    b, n, k = idx.shape
    bx, by, bz = core
    _, (_, ey, ez) = block_geometry(cells, window, core)
    w = window
    ii = torch.arange(n, dtype=torch.int32, device=idx.device)
    x = torch.div(ii, cells * cells, rounding_mode="floor")
    y = torch.remainder(torch.div(ii, cells, rounding_mode="floor"), cells)
    z = torch.remainder(ii, cells)
    nx = torch.div(idx, cells * cells, rounding_mode="floor")
    ny = torch.remainder(torch.div(idx, cells, rounding_mode="floor"), cells)
    nz = torch.remainder(idx, cells)

    def wrapd(a, a0):
        return torch.remainder(a - a0 + cells // 2, cells) - cells // 2

    lx = torch.remainder(x, bx)[None, :, None] + w + wrapd(nx, x[None, :, None])
    ly = torch.remainder(y, by)[None, :, None] + w + wrapd(ny, y[None, :, None])
    lz = torch.remainder(z, bz)[None, :, None] + w + wrapd(nz, z[None, :, None])
    p = (lx * ey + ly) * ez + lz                     # (B, N, K)
    p_blocks = cube_to_blocks(p.to(torch.int32), cells, core)   # (B, NB, R, K)
    return p_blocks.reshape(b, -1, bx * by * bz * k)


@torch.no_grad()
def block_positions(idx: torch.Tensor, cells: int, window: int,
                    core: Sequence[int] = MASKED_CORE,
                    drop_self_slot0: bool = False) -> torch.Tensor:
    """(B, N, K) lattice-kNN ids -> (B, NB, ET) int32 per-edge patch
    positions, the index route's only per-step array.  drop_self_slot0:
    slot 0 is the particle itself; leave it out (ET = R*(K-1)) and let the
    consumers copy it (self_slot0=True)."""
    if drop_self_slot0:
        idx = idx[:, :, 1:]
    return edge_block_positions(idx, cells, window, core)


def masked_gather(values: torch.Tensor, pos: torch.Tensor, cells: int,
                  window: int, core: Sequence[int] = MASKED_CORE,
                  self_slot0: bool = False) -> torch.Tensor:
    """values (B, N, C), positions from block_positions -> (B, N, K, C) in
    values' dtype (kernel D; the selection runs in bf16).  self_slot0:
    slot 0 of the output is values itself."""
    b, n, c = values.shape
    bx, by, bz = core
    r = bx * by * bz
    k = pos.shape[2] // r
    patches = block_patches(values, cells, window, core)   # (B, NB, P, C)
    out = idx_dot_gather(pos, patches)
    out = out.reshape(b, -1, r, k * c)
    out = blocks_to_cube(out, cells, core).reshape(b, n, k, c).to(values.dtype)
    if self_slot0:
        out = torch.cat([values[:, :, None, :], out], dim=2)
    return out


def masked_scatter_add(vals: torch.Tensor, pos: torch.Tensor, cells: int,
                       window: int, core: Sequence[int] = MASKED_CORE,
                       self_slot0: bool = False) -> torch.Tensor:
    """vals (B, N, K, C) -> (B, N, C) sums by target id (kernel E, then the
    f32 fold, then one cast to vals' dtype).  self_slot0: slot 0 targets
    the particle itself and is added directly."""
    self_part = None
    if self_slot0:
        self_part = vals[:, :, 0, :]
        vals = vals[:, :, 1:, :]
    b, n, k, c = vals.shape
    bx, by, bz = core
    v_blocks = cube_to_blocks(vals.reshape(b, n, k * c), cells, core)
    v_blocks = v_blocks.reshape(b, -1, bx * by * bz * k, c)
    acc = idx_dot_scatter(pos, v_blocks, patch_size(cells, window, core))
    out = patches_fold(acc, cells, window, core).to(vals.dtype)
    if self_part is not None:
        out = out + self_part
    return out


def masked_gather_blocks(values: torch.Tensor, pos: torch.Tensor, cells: int,
                         window: int, core: Sequence[int] = MASKED_CORE,
                         self_slot0: bool = False) -> torch.Tensor:
    """Cube node field (B, N, C) -> BLOCK-MAJOR edges (B, NB, R, K, C), for
    callers that keep edge activations block-major (no cube transpose of
    the edge tensor)."""
    b, _, c = values.shape
    bx, by, bz = core
    r = bx * by * bz
    k = pos.shape[2] // r
    patches = block_patches(values, cells, window, core)
    out = idx_dot_gather(pos, patches).reshape(b, -1, r, k, c).to(values.dtype)
    if self_slot0:
        selfv = cube_to_blocks(values, cells, core)       # (B, NB, R, C)
        out = torch.cat([selfv[:, :, :, None, :], out], dim=3)
    return out


def masked_scatter_add_blocks(vals: torch.Tensor, pos: torch.Tensor,
                              cells: int, window: int,
                              core: Sequence[int] = MASKED_CORE,
                              self_slot0: bool = False) -> torch.Tensor:
    """BLOCK-MAJOR edges (B, NB, R, K, C) -> cube node sums (B, N, C)."""
    self_part = None
    if self_slot0:
        self_part = vals[:, :, :, 0, :]                   # (B, NB, R, C)
        vals = vals[:, :, :, 1:, :]
    b, nb, r, k, c = vals.shape
    v = vals.reshape(b, nb, r * k, c)
    acc = idx_dot_scatter(pos, v, patch_size(cells, window, core))
    out = patches_fold(acc, cells, window, core).to(vals.dtype)
    if self_part is not None:
        out = out + blocks_to_cube(self_part, cells, core)
    return out


def edges_cube_to_blocks(edges: torch.Tensor, cells: int,
                         core: Sequence[int] = MASKED_CORE) -> torch.Tensor:
    """(B, N, K, C) -> (B, NB, R, K, C) block-major edge activations."""
    b, n, k, c = edges.shape
    bx, by, bz = core
    v = cube_to_blocks(edges.reshape(b, n, k * c), cells, core)
    return v.reshape(b, -1, bx * by * bz, k, c)


def nodes_blocks_to_cube(x: torch.Tensor, cells: int,
                         core: Sequence[int] = MASKED_CORE) -> torch.Tensor:
    """(B, NB, R, C) block-major node field -> (B, N, C)."""
    return blocks_to_cube(x, cells, core)


def block_gather(values: torch.Tensor, idx: torch.Tensor, cells: int,
                 window: int, fast: bool = True) -> torch.Tensor:
    """values (B, N, C), idx (B, N, K) lattice-kNN ids -> (B, N, K, C) in
    values' dtype, over CORE blocks (kernel F; not differentiable:
    ops/banded pairs it with block_scatter_add)."""
    core = CORE
    b, n, c = values.shape
    k = idx.shape[-1]
    bx, by, bz = core
    patches = block_patches(values, cells, window, core)
    p = edge_block_positions(idx, cells, window, core)
    out = BK.block_gather(p, patches, fast=fast)
    out = out.reshape(b, -1, bx * by * bz, k * c)
    return blocks_to_cube(out, cells, core).reshape(b, n, k, c)


def block_scatter_add(vals: torch.Tensor, idx: torch.Tensor, cells: int,
                      window: int, fast: bool = True) -> torch.Tensor:
    """vals (B, N, K, C), idx (B, N, K) -> (B, N, C) summed by target id,
    in vals' dtype, over CORE blocks (kernel G, then the f32 fold)."""
    core = CORE
    b, n, k, c = vals.shape
    bx, by, bz = core
    p = edge_block_positions(idx, cells, window, core)
    v_blocks = cube_to_blocks(vals.reshape(b, n, k * c), cells, core)
    v_blocks = v_blocks.reshape(b, -1, bx * by * bz * k, c)
    acc = BK.block_scatter(p, v_blocks, patch_size(cells, window, core),
                           fast=fast)
    return patches_fold(acc, cells, window, core).to(vals.dtype)
