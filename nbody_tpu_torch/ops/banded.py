"""Neighbor gather / scatter-add with gradients (port of the batched
dispatch of nbody_tpu/ops/banded.py:178-322).

Three routes, chosen by the ``lattice`` / ``masks`` arguments as in JAX:
  * masks (the BlockPlan of per-edge patch positions from
    ops/blocked.block_index_plan, or int8 / packed int4 masks from
    block_masks) with lattice=(cells, window, core, self_free): the masked
    index or integer-mask route, ops/blocked.masked_* on kernels D/E or
    H/I; autograd runs through the patch views and the kernels' own
    autograd pairs;
  * lattice=(cells, window) without masks, on a cube the CORE block tiles
    (``_block_ok``): the ``--impl block`` route, kernels F/G over a
    BlockPlan of CORE blocks;
  * otherwise: the direct kernels B/C.  The port computes their exact
    (band=None) semantics, which is what the banded kernels compute under
    lattice kNN anyway (ops/banded.py:37-46).  Kernel C runs over a
    GraphPlan (the edges sorted by target).
On the direct and block routes pass ``plan=`` (the GraphPlan, or the block
route's BlockPlan, built once per forward) to share it across a step's
ops, the backward ones included; without one each op builds its own.
On the direct and block routes each op's gradient is the other op, as in
the JAX custom VJPs (ops/banded.py:221-254).  The block route runs F/G
with ``fast`` = (values are bf16): exact in either dtype, the JAX CPU
semantics (on the TPU it rounded f32 values to bf16).

``default_band`` and ``band_violations`` are the index-band arithmetic of
ops/banded.py:37-46 and :154-161: the band the banded kNN search and the
coverage guard assume, and the count of links outside it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.kernels import banded_kernels as K
from nbody_tpu_torch.ops.kernels.banded_kernels import GraphPlan, graph_plan
from nbody_tpu_torch.ops.kernels.block_kernels import BlockPlan


def default_band(cells: int, window: int = 3) -> int:
    """Index band covering every flat offset a +-window lattice-kNN
    neighbor can have: |rel| <= window*c^2 + (c-1)*c + (c-1) < (window+1)*c^2
    (a wrapped y or z coordinate does not fold in flat index space), so
    band = 2*(window+1)*c^2, rounded up to 256 and capped at N."""
    n = cells ** 3
    return min(n, -(-2 * (window + 1) * cells * cells // 256) * 256)


def band_violations(idx: torch.Tensor, band: int) -> torch.Tensor:
    """Neighbor links outside the circular band (0 for a correct band):
    idx (..., N, K); rel in [-band//2, band//2] is in band."""
    n = idx.shape[-2]
    rows = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    rel = torch.remainder(idx - rows + n // 2, n) - n // 2
    return torch.sum((rel < -(band // 2)) | (rel > band // 2))


def _block_ok(n: int, lattice) -> bool:
    """The block kernels need a full cells^3 cube that CORE tiles evenly;
    anything else takes the direct route."""
    if lattice is None:
        return False
    cells = lattice[0]
    return n == cells ** 3 and all(cells % d == 0 for d in blocked.CORE)


def route_plan(idx: torch.Tensor, lattice=None,
               masks=None) -> Optional[Union[GraphPlan, BlockPlan]]:
    """The plan a forward's neighbor ops share, built once: graph_plan(idx)
    on the direct route, the BlockPlan of CORE blocks on the block route,
    and None on the masked routes, whose plan or masks travel as `masks`."""
    if masks is not None and lattice is not None:
        return None
    if _block_ok(idx.shape[1], lattice):
        return blocked.block_index_plan(idx, lattice[0], lattice[1], blocked.CORE)
    return graph_plan(idx)


def _gather_impl(values: torch.Tensor, idx: torch.Tensor, lattice,
                 plan) -> torch.Tensor:
    if _block_ok(values.shape[1], lattice):
        return blocked.block_gather(values, plan if plan is not None else
                                    route_plan(idx, lattice), lattice[0],
                                    lattice[1], fast=values.dtype == torch.bfloat16)
    return K.neighbor_gather(values, idx)


def _scatter_impl(vals: torch.Tensor, idx: torch.Tensor, lattice,
                  plan) -> torch.Tensor:
    plan = plan if plan is not None else route_plan(idx, lattice)
    if _block_ok(vals.shape[1], lattice):
        return blocked.block_scatter_add(vals, plan, lattice[0], lattice[1],
                                         fast=vals.dtype == torch.bfloat16)
    return K.neighbor_scatter_add(vals, idx, plan)


def _save(ctx, idx, plan):
    ctx.save_for_backward(idx, *(plan if plan is not None else ()))
    ctx.plan_type = type(plan)


def _saved(ctx):
    idx, *plan = ctx.saved_tensors
    return idx, (ctx.plan_type(*plan) if plan else None)


class NeighborGather(torch.autograd.Function):
    """values (b, N, C), idx (b, N, K) -> (b, N, K, C); grad: scatter-add
    (over `plan` when given)."""

    @staticmethod
    def forward(ctx, values, idx, lattice, plan):
        _save(ctx, idx, plan)
        ctx.lattice = lattice
        return _gather_impl(values.contiguous(), idx, lattice, plan)

    @staticmethod
    def backward(ctx, ct):
        idx, plan = _saved(ctx)
        return (_scatter_impl(ct.contiguous(), idx, ctx.lattice, plan),
                None, None, None)


class NeighborScatterAdd(torch.autograd.Function):
    """vals (b, N, K, C), idx (b, N, K) -> (b, N, C); grad: gather (over
    `plan`'s positions on the block route)."""

    @staticmethod
    def forward(ctx, vals, idx, lattice, plan):
        _save(ctx, idx, plan)
        ctx.lattice = lattice
        return _scatter_impl(vals.contiguous(), idx, lattice, plan)

    @staticmethod
    def backward(ctx, ct):
        idx, plan = _saved(ctx)
        return (_gather_impl(ct.contiguous(), idx, ctx.lattice, plan),
                None, None, None)


def neighbor_gather(values: torch.Tensor, idx: torch.Tensor, lattice=None,
                    masks=None,
                    plan=None) -> torch.Tensor:
    """Batched gather: values (b, N, C), idx (b, N, K) -> (b, N, K, C).
    `plan` (route_plan(idx, lattice)) serves the gradient's scatter, and
    on the block route the gather's positions."""
    if masks is not None and lattice is not None:
        return blocked.masked_gather(
            values, masks, lattice[0], lattice[1],
            core=blocked.lattice_core(lattice),
            self_slot0=blocked.lattice_self_free(lattice))
    return NeighborGather.apply(values, idx, lattice, plan)


def neighbor_scatter_add(vals: torch.Tensor, idx: torch.Tensor, lattice=None,
                         masks=None,
                         plan=None) -> torch.Tensor:
    """Batched scatter-add: vals (b, N, K, C), idx (b, N, K) -> (b, N, C),
    over `plan` (route_plan(idx, lattice)) on the direct and block routes
    when given."""
    if masks is not None and lattice is not None:
        return blocked.masked_scatter_add(
            vals, masks, lattice[0], lattice[1],
            core=blocked.lattice_core(lattice),
            self_slot0=blocked.lattice_self_free(lattice))
    return NeighborScatterAdd.apply(vals, idx, lattice, plan)


def neighbor_counts(idx: torch.Tensor, dtype=torch.float32, lattice=None,
                    masks=None, plan=None) -> torch.Tensor:
    """In-degree of each particle in the kNN graph: (b, N, K) -> (b, N).

    Depends only on idx: compute once per step and share across layers.
    The direct route reads it off the graph plan's offsets, the index and
    block routes off their BlockPlan's (ops/blocked.plan_counts); the
    int8/int4 route scatters ones."""
    b, n = idx.shape[:2]
    if masks is not None and lattice is not None:
        return blocked.masked_counts(masks, lattice[0], lattice[1],
                                     blocked.lattice_core(lattice),
                                     blocked.lattice_self_free(lattice), dtype)
    plan = plan if plan is not None else route_plan(idx, lattice)
    if isinstance(plan, BlockPlan):
        return blocked.plan_counts(plan, lattice[0], lattice[1], blocked.CORE,
                                   dtype=dtype)
    return plan.in_degree(b, n, dtype)


def neighbor_segment_mean(vals: torch.Tensor, idx: torch.Tensor,
                          counts: Optional[torch.Tensor] = None,
                          lattice=None,
                          masks=None, plan=None) -> torch.Tensor:
    """Mean of edge values grouped by neighbor id: (b,N,K,C) -> (b,N,C),
    tf.unsorted_segment_mean semantics (empty targets -> 0).  Pass
    precomputed `counts` (neighbor_counts) and, on the direct and block
    routes, the step's `plan` to share them across layers."""
    sums = neighbor_scatter_add(vals, idx, lattice, masks, plan)
    cnt = counts if counts is not None else neighbor_counts(
        idx, vals.dtype, lattice, masks, plan)
    return sums / torch.clamp_min(cnt, 1.0)[..., None]
