"""Neighbor gather / scatter-add with gradients (port of the batched
dispatch of nbody_tpu/ops/banded.py:221-322).

Each op's gradient is the other op, as in the JAX custom VJPs
(ops/banded.py:221-254): the gather's backward is the scatter kernel and
the scatter's backward is the gather kernel.  There is no band, lattice or
masks argument: the port computes the exact (band=None) semantics, which
is what the banded kernels compute under lattice kNN anyway, because
``default_band`` provably covers every lattice edge (ops/banded.py:37-46).
"""

from __future__ import annotations

from typing import Optional

import torch

from nbody_tpu_torch.ops.kernels import banded_kernels as K


class NeighborGather(torch.autograd.Function):
    """values (b, N, C), idx (b, N, K) -> (b, N, K, C); grad: scatter-add."""

    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        return K.neighbor_gather(values.contiguous(), idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return K.neighbor_scatter_add(ct.contiguous(), idx), None


class NeighborScatterAdd(torch.autograd.Function):
    """vals (b, N, K, C), idx (b, N, K) -> (b, N, C); grad: gather."""

    @staticmethod
    def forward(ctx, vals, idx):
        ctx.save_for_backward(idx)
        return K.neighbor_scatter_add(vals.contiguous(), idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return K.neighbor_gather(ct.contiguous(), idx), None


def neighbor_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: values (b, N, C), idx (b, N, K) -> (b, N, K, C)."""
    return NeighborGather.apply(values, idx)


def neighbor_scatter_add(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched scatter-add: vals (b, N, K, C), idx (b, N, K) -> (b, N, C)."""
    return NeighborScatterAdd.apply(vals, idx)


def neighbor_counts(idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """In-degree of each particle in the kNN graph: (b, N, K) -> (b, N).

    Depends only on idx: compute once per step and share across layers."""
    ones = torch.ones(idx.shape + (1,), dtype=dtype, device=idx.device)
    with torch.no_grad():
        return K.neighbor_scatter_add(ones, idx)[..., 0]


def neighbor_segment_mean(vals: torch.Tensor, idx: torch.Tensor,
                          counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of edge values grouped by neighbor id: (b,N,K,C) -> (b,N,C),
    tf.unsorted_segment_mean semantics (empty targets -> 0).  Pass
    precomputed `counts` (neighbor_counts) to skip re-scattering ones."""
    sums = neighbor_scatter_add(vals, idx)
    cnt = counts if counts is not None else neighbor_counts(idx, vals.dtype)
    return sums / torch.clamp_min(cnt, 1.0)[..., None]
