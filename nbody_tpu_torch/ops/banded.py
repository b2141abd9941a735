"""Neighbor gather / scatter-add with gradients (port of the batched
dispatch of nbody_tpu/ops/banded.py:178-322).

Three routes, chosen by the ``lattice`` / ``masks`` arguments as in JAX:
  * masks (per-edge patch positions from ops/blocked.block_positions)
    with lattice=(cells, window, core, self_free): the masked index route,
    ops/blocked.masked_* on kernels D/E; autograd runs through the patch
    views and the kernels' own autograd pair;
  * lattice=(cells, window) without masks, on a cube the CORE block tiles
    (``_block_ok``): the ``--impl block`` route, kernels F/G;
  * otherwise: the direct kernels B/C.  The port computes their exact
    (band=None) semantics, which is what the banded kernels compute under
    lattice kNN anyway (ops/banded.py:37-46).
On the direct and block routes each op's gradient is the other op, as in
the JAX custom VJPs (ops/banded.py:221-254).  The block route runs F/G
with ``fast`` = (values are bf16): exact in either dtype, the JAX CPU
semantics (on the TPU it rounded f32 values to bf16).
"""

from __future__ import annotations

from typing import Optional

import torch

from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.kernels import banded_kernels as K


def _block_ok(n: int, lattice) -> bool:
    """The block kernels need a full cells^3 cube that CORE tiles evenly;
    anything else takes the direct route."""
    if lattice is None:
        return False
    cells = lattice[0]
    return n == cells ** 3 and all(cells % d == 0 for d in blocked.CORE)


def _gather_impl(values: torch.Tensor, idx: torch.Tensor, lattice) -> torch.Tensor:
    if _block_ok(values.shape[1], lattice):
        return blocked.block_gather(values, idx, lattice[0], lattice[1],
                                    fast=values.dtype == torch.bfloat16)
    return K.neighbor_gather(values, idx)


def _scatter_impl(vals: torch.Tensor, idx: torch.Tensor, lattice) -> torch.Tensor:
    if _block_ok(vals.shape[1], lattice):
        return blocked.block_scatter_add(vals, idx, lattice[0], lattice[1],
                                         fast=vals.dtype == torch.bfloat16)
    return K.neighbor_scatter_add(vals, idx)


class NeighborGather(torch.autograd.Function):
    """values (b, N, C), idx (b, N, K) -> (b, N, K, C); grad: scatter-add."""

    @staticmethod
    def forward(ctx, values, idx, lattice):
        ctx.save_for_backward(idx)
        ctx.lattice = lattice
        return _gather_impl(values.contiguous(), idx, lattice)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return _scatter_impl(ct.contiguous(), idx, ctx.lattice), None, None


class NeighborScatterAdd(torch.autograd.Function):
    """vals (b, N, K, C), idx (b, N, K) -> (b, N, C); grad: gather."""

    @staticmethod
    def forward(ctx, vals, idx, lattice):
        ctx.save_for_backward(idx)
        ctx.lattice = lattice
        return _scatter_impl(vals.contiguous(), idx, lattice)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return _gather_impl(ct.contiguous(), idx, ctx.lattice), None, None


def neighbor_gather(values: torch.Tensor, idx: torch.Tensor, lattice=None,
                    masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched gather: values (b, N, C), idx (b, N, K) -> (b, N, K, C)."""
    if masks is not None and lattice is not None:
        return blocked.masked_gather(
            values, masks, lattice[0], lattice[1],
            core=blocked.lattice_core(lattice),
            self_slot0=blocked.lattice_self_free(lattice))
    return NeighborGather.apply(values, idx, lattice)


def neighbor_scatter_add(vals: torch.Tensor, idx: torch.Tensor, lattice=None,
                         masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched scatter-add: vals (b, N, K, C), idx (b, N, K) -> (b, N, C)."""
    if masks is not None and lattice is not None:
        return blocked.masked_scatter_add(
            vals, masks, lattice[0], lattice[1],
            core=blocked.lattice_core(lattice),
            self_slot0=blocked.lattice_self_free(lattice))
    return NeighborScatterAdd.apply(vals, idx, lattice)


def neighbor_counts(idx: torch.Tensor, dtype=torch.float32, lattice=None,
                    masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-degree of each particle in the kNN graph: (b, N, K) -> (b, N).

    Depends only on idx: compute once per step and share across layers."""
    ones = torch.ones(idx.shape + (1,), dtype=dtype, device=idx.device)
    with torch.no_grad():
        return neighbor_scatter_add(ones, idx, lattice, masks)[..., 0]


def neighbor_segment_mean(vals: torch.Tensor, idx: torch.Tensor,
                          counts: Optional[torch.Tensor] = None,
                          lattice=None,
                          masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of edge values grouped by neighbor id: (b,N,K,C) -> (b,N,C),
    tf.unsorted_segment_mean semantics (empty targets -> 0).  Pass
    precomputed `counts` (neighbor_counts) to skip re-scattering ones."""
    sums = neighbor_scatter_add(vals, idx, lattice, masks)
    cnt = counts if counts is not None else neighbor_counts(
        idx, vals.dtype, lattice, masks)
    return sums / torch.clamp_min(cnt, 1.0)[..., None]
