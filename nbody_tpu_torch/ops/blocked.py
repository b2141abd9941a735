"""3D-block gather/scatter for lattice kNN graphs (port of
nbody_tpu/ops/blocked.py).

Every neighbor of a particle in a (bx, by, bz) core block lies inside the
block's dilated patch of P = (bx+2w)(by+2w)(bz+2w) lattice sites (w the
lattice window).  A neighbor op then becomes, per block, a selection
against the patch by a per-edge position in [0, P):

  cube_to_blocks / blocks_to_cube   reshapes + permutes between the z-major
                                    cube order and block-major order;
  block_patches                     the dilated patches, gathered from the
                                    periodic cube (one copy);
  edge_block_positions              each edge's neighbor as a position in
                                    its block's patch (integer arithmetic);
  block_index_plan                  the positions with the edges sorted by
                                    patch site (a BlockPlan, once per step);
  block_masks                       the same positions as one-hot
                                    (ET, P) masks, int8 or packed int4;
  kernels D/E (ops/kernels/idx_kernels.py, the index route of the masked
  path), H/I (ops/kernels/mask_kernels.py, the int8/int4 route) or F/G
  (ops/kernels/block_kernels.py, ``--impl block``)
                                    the per-block selection and its sum;
  patches_fold                      the transpose of block_patches: the
                                    per-block (P, C) sums overlap-added
                                    back into the cube, in f32.

block_patches and patches_fold are one CUDA pass each on a card
(ops/kernels/block_layout.py -> csrc/block_layout.cu), their plain versions
on the CPU.

Requires N == cells^3 in grid order and |offset| <= window per axis, which
the lattice kNN guarantees.  The core shape travels as an argument; the
JAX module's default cores are the two constants below (its set_core
globals are not ported).  The masked ops take either the index route's
BlockPlan (its positions, where JAX takes the positions themselves) or
integer masks (the int8/int4 route); the bf16/f32 one-hot masks of JAX's
einsum route are built here only as kernel J's input (the route itself
runs the direct kernels in the port).  The in-degree counts of the index
and block routes are read off the plan (``plan_counts``), with no kernel
launch.  The layout work (block_patches, patches_fold,
edges_cube_to_blocks, nodes_blocks_to_cube) is marked apart, forward and
backward, in an open step timeline (tracing.layout: segments ``*.layout``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import block_kernels as BK
from nbody_tpu_torch.ops.kernels import block_layout as BL
from nbody_tpu_torch.ops.kernels.block_layout import block_geometry
from nbody_tpu_torch.ops.kernels.block_kernels import BlockPlan
from nbody_tpu_torch.ops.kernels.idx_kernels import idx_dot_gather, idx_dot_scatter
from nbody_tpu_torch.ops.kernels.mask_kernels import (mask_dot_gather,
                                                      mask_dot_scatter)
# the int4 packing of block_masks(dtype="int4"), for the plain versions and tests
from nbody_tpu_torch.ops.kernels.mask_kernels import pack_int4, unpack_int4  # noqa: F401

# default core of the --impl block route
CORE = (4, 4, 8)
# default (first-choice) core of the masked index route
MASKED_CORE = (4, 8, 8)

Core = Tuple[int, int, int]


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


class _BlockPatches(torch.autograd.Function):
    """block_patches with patches_fold as its gradient, in the cotangent's
    dtype: JAX transposes block_patches in the patches' dtype, in the same
    order of adds."""

    @staticmethod
    def forward(ctx, values, cells, window, core):
        ctx.geom = (cells, window, core)
        return BL.block_patches(values, cells, window, core)

    @staticmethod
    def backward(ctx, ct):
        return BL.patches_fold(ct, *ctx.geom), None, None, None


class _PatchesFold(torch.autograd.Function):
    """patches_fold with block_patches as its gradient."""

    @staticmethod
    def forward(ctx, acc, cells, window, core):
        ctx.geom = (cells, window, core)
        return BL.patches_fold(acc, cells, window, core)

    @staticmethod
    def backward(ctx, ct):
        return BL.block_patches(ct, *ctx.geom), None, None, None


def block_patches(values: torch.Tensor, cells: int, window: int,
                  core: Sequence[int]) -> torch.Tensor:
    """(B, N, C) -> (B, NB, P, C): each core block's dilated patch, in
    (lx, ly, lz) order (block_layout.block_patches: one copy).  Its
    gradient is patches_fold (an autograd pair, so autograd records no
    slice ops)."""
    return tracing.layout("block_patches", _BlockPatches.apply, values, cells,
                          window, tuple(core))


def patches_fold(acc: torch.Tensor, cells: int, window: int,
                 core: Sequence[int]) -> torch.Tensor:
    """(B, NB, P, C) per-block sums -> (B, N, C): the exact transpose of
    block_patches, with the JAX package's order of adds (z, then y, then x
    strided slice-adds into the padded cube, then the pad rings folded
    back axis by axis), so f32 sums are bit-equal to it
    (block_layout.patches_fold; on a card one pass that adds each row in
    that order).  Its gradient is block_patches."""
    return tracing.layout("patches_fold", _PatchesFold.apply, acc, cells,
                          window, tuple(core))


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


@torch.no_grad()
def block_index_plan(idx: torch.Tensor, cells: int, window: int,
                     core: Sequence[int] = MASKED_CORE,
                     drop_self_slot0: bool = False) -> BlockPlan:
    """(B, N, K) lattice-kNN ids -> the BlockPlan of their block_positions:
    the positions, and the edges sorted by patch site for the scatters.
    Built once per step and shared by every selection of the step,
    forward and backward."""
    return BK.block_plan(block_positions(idx, cells, window, core,
                                         drop_self_slot0),
                         patch_size(cells, window, core))


@torch.no_grad()
def plan_counts(plan: BlockPlan, cells: int, window: int, core: Sequence[int],
                self_slot0: bool = False, dtype=torch.float32) -> torch.Tensor:
    """In-degree of every cube node (B, N) in `dtype`, read off the plan:
    the per-site degrees folded back into the cube in f32, plus the self
    slot -- the width-1 scatter of ones, without a kernel launch."""
    deg = plan.site_degree().to(torch.float32)[..., None]
    out = patches_fold(deg, cells, window, core).to(dtype)[..., 0]
    return out + 1 if self_slot0 else out


@torch.no_grad()
def block_masks(idx: torch.Tensor, cells: int, window: int,
                dtype=torch.int8, core: Sequence[int] = MASKED_CORE,
                drop_self_slot0: bool = False) -> torch.Tensor:
    """(B, N, K) lattice-kNN ids -> (B, NB, ET, P) one-hot selection masks,
    the JAX encoding of block_positions (blocked.py:236-265).

    dtype torch.int8 (the int8 route), torch.bfloat16 or torch.float32
    (kernel J's masks), or "int4": packed (B, NB, ET, P/2) uint8, the entry
    of even column p in the low nibble (ops/kernels/mask_kernels.py).  Built
    by a scatter of ones at the positions, never a (..., P) comparison; a
    position outside [0, P) leaves its row zero, as the comparison did."""
    pos = block_positions(idx, cells, window, core, drop_self_slot0)
    p = patch_size(cells, window, core)
    valid = (pos >= 0) & (pos < p)
    at = torch.where(valid, pos, 0).long()
    if dtype == "int4":
        if p % 2:
            raise ValueError(f"int4 masks need an even patch size, P={p}")
        one = torch.where(at % 2 == 0, 0x01, 0x10).to(torch.uint8)
        out = torch.zeros(pos.shape + (p // 2,), dtype=torch.uint8,
                          device=idx.device)
        return out.scatter_(3, (at // 2)[..., None],
                            (one * valid.to(torch.uint8))[..., None])
    if dtype not in (torch.int8, torch.bfloat16, torch.float32):
        raise ValueError(f"block_masks: dtype {dtype!r} is not one of int8, "
                         "'int4', bfloat16, float32")
    out = torch.zeros(pos.shape + (p,), dtype=dtype, device=idx.device)
    return out.scatter_(3, at[..., None], valid[..., None].to(dtype))


def _edges_per_block(masks) -> int:
    return (masks.pos if isinstance(masks, BlockPlan) else masks).shape[2]


def _mask_contract_gather(masks, patches: torch.Tensor) -> torch.Tensor:
    """(B, NB, P, C) patches -> (B, NB, ET, C) edges through the route's
    masks: a BlockPlan runs kernel D on its positions (bf16 out), int8 or
    packed int4 (B, NB, ET, P[/2]) masks kernel H (f32 out)."""
    if isinstance(masks, BlockPlan):
        return idx_dot_gather(masks, patches)
    return mask_dot_gather(masks, patches)


def _mask_contract_scatter(masks, edges: torch.Tensor,
                           p_size: int) -> torch.Tensor:
    """The transpose: (B, NB, ET, C) -> (B, NB, P, C) f32 per-block sums
    (kernel E over a BlockPlan, I for masks; p_size = P, which the masks
    carry themselves)."""
    if isinstance(masks, BlockPlan):
        return idx_dot_scatter(masks, edges, p_size)
    return mask_dot_scatter(masks, edges)


def masked_gather(values: torch.Tensor, masks, cells: int,
                  window: int, core: Sequence[int] = MASKED_CORE,
                  self_slot0: bool = False) -> torch.Tensor:
    """values (B, N, C), a BlockPlan from block_index_plan or masks from
    block_masks -> (B, N, K, C) in values' dtype (kernel D or H; the
    selection runs in bf16).  self_slot0: slot 0 of the output is values
    itself."""
    b, n, c = values.shape
    bx, by, bz = core
    r = bx * by * bz
    k = _edges_per_block(masks) // r
    patches = block_patches(values, cells, window, core)   # (B, NB, P, C)
    out = _mask_contract_gather(masks, patches)
    out = out.reshape(b, -1, r, k * c)
    out = blocks_to_cube(out, cells, core).reshape(b, n, k, c).to(values.dtype)
    if self_slot0:
        out = torch.cat([values[:, :, None, :], out], dim=2)
    return out


def masked_scatter_add(vals: torch.Tensor, masks, cells: int,
                       window: int, core: Sequence[int] = MASKED_CORE,
                       self_slot0: bool = False) -> torch.Tensor:
    """vals (B, N, K, C) -> (B, N, C) sums by target id (kernel E or I,
    then the f32 fold, then one cast to vals' dtype).  self_slot0: slot 0
    targets the particle itself and is added directly."""
    self_part = None
    if self_slot0:
        self_part = vals[:, :, 0, :]
        vals = vals[:, :, 1:, :]
    b, n, k, c = vals.shape
    bx, by, bz = core
    v_blocks = cube_to_blocks(vals.reshape(b, n, k * c), cells, core)
    v_blocks = v_blocks.reshape(b, -1, bx * by * bz * k, c)
    acc = _mask_contract_scatter(masks, v_blocks,
                                 patch_size(cells, window, core))
    out = patches_fold(acc, cells, window, core).to(vals.dtype)
    if self_part is not None:
        out = out + self_part
    return out


def masked_gather_blocks(values: torch.Tensor, masks, cells: int,
                         window: int, core: Sequence[int] = MASKED_CORE,
                         self_slot0: bool = False) -> torch.Tensor:
    """Cube node field (B, N, C) -> BLOCK-MAJOR edges (B, NB, R, K, C), for
    callers that keep edge activations block-major (no cube transpose of
    the edge tensor)."""
    b, _, c = values.shape
    bx, by, bz = core
    r = bx * by * bz
    k = _edges_per_block(masks) // r
    patches = block_patches(values, cells, window, core)
    out = _mask_contract_gather(masks, patches).reshape(b, -1, r, k, c).to(
        values.dtype)
    if self_slot0:
        selfv = cube_to_blocks(values, cells, core)       # (B, NB, R, C)
        out = torch.cat([selfv[:, :, :, None, :], out], dim=3)
    return out


def masked_scatter_add_blocks(vals: torch.Tensor, masks,
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
    acc = _mask_contract_scatter(masks, v, patch_size(cells, window, core))
    out = patches_fold(acc, cells, window, core).to(vals.dtype)
    if self_part is not None:
        out = out + blocks_to_cube(self_part, cells, core)
    return out


@torch.no_grad()
def masked_counts(masks, cells: int, window: int,
                  core: Sequence[int] = MASKED_CORE, self_slot0: bool = False,
                  dtype=torch.float32) -> torch.Tensor:
    """In-degree (B, N) of every cube node on a masked route, in `dtype`:
    off the plan (plan_counts) on the index route, a width-1 scatter of
    ones through kernel I on the int8/int4 route."""
    if isinstance(masks, BlockPlan):
        return plan_counts(masks, cells, window, core, self_slot0, dtype)
    ones = torch.ones(masks.shape[:3] + (1,), dtype=dtype, device=masks.device)
    acc = _mask_contract_scatter(masks, ones, patch_size(cells, window, core))
    out = patches_fold(acc, cells, window, core).to(dtype)[..., 0]
    return out + 1 if self_slot0 else out


def _edges_cube_to_blocks(edges: torch.Tensor, cells: int,
                          core: Core) -> torch.Tensor:
    b, n, k, c = edges.shape
    bx, by, bz = core
    v = cube_to_blocks(edges.reshape(b, n, k * c), cells, core)
    return v.reshape(b, -1, bx * by * bz, k, c)


def edges_cube_to_blocks(edges: torch.Tensor, cells: int,
                         core: Sequence[int] = MASKED_CORE) -> torch.Tensor:
    """(B, N, K, C) -> (B, NB, R, K, C) block-major edge activations."""
    return tracing.layout("edges_cube_to_blocks", _edges_cube_to_blocks, edges,
                          cells, tuple(core))


def nodes_blocks_to_cube(x: torch.Tensor, cells: int,
                         core: Sequence[int] = MASKED_CORE) -> torch.Tensor:
    """(B, NB, R, C) block-major node field -> (B, N, C)."""
    return tracing.layout("nodes_blocks_to_cube", blocks_to_cube, x, cells,
                          tuple(core))


def block_gather(values: torch.Tensor, plan: BlockPlan, cells: int,
                 window: int, fast: bool = True) -> torch.Tensor:
    """values (B, N, C), the step's block_index_plan over CORE blocks
    (every slot, the self edge included) -> (B, N, K, C) in
    values' dtype, over CORE blocks (kernel F; not differentiable:
    ops/route pairs it with block_scatter_add)."""
    core = CORE
    b, n, c = values.shape
    bx, by, bz = core
    r = bx * by * bz
    k = plan.pos.shape[2] // r
    patches = block_patches(values, cells, window, core)
    out = BK.block_gather(plan.pos, patches, fast=fast)
    out = out.reshape(b, -1, r, k * c)
    return blocks_to_cube(out, cells, core).reshape(b, n, k, c)


def block_scatter_add(vals: torch.Tensor, plan: BlockPlan, cells: int,
                      window: int, fast: bool = True) -> torch.Tensor:
    """vals (B, N, K, C), the step's block_index_plan over CORE blocks
    -> (B, N, C) summed
    by target id, in vals' dtype, over CORE blocks (kernel G, then the f32
    fold)."""
    core = CORE
    b, n, k, c = vals.shape
    bx, by, bz = core
    v_blocks = cube_to_blocks(vals.reshape(b, n, k * c), cells, core)
    v_blocks = v_blocks.reshape(b, -1, bx * by * bz * k, c)
    acc = BK.block_scatter(plan, v_blocks, patch_size(cells, window, core),
                           fast=fast)
    return patches_fold(acc, cells, window, core).to(vals.dtype)
