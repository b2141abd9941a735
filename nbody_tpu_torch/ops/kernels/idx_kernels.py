"""Kernels D and E: the index-position gather and scatter of the mask-free
masked path (``--mask_dtype index``), and their autograd pair.

Replace nbody_tpu/ops/pallas/idx_kernels.py : idx_dot_gather and
idx_dot_scatter (the ``_idx_pair`` custom VJPs).  Per (batch, core
block), pos (B, NB, ET) int32 indexes the block's dilated patch of P sites:
  idx_dot_gather:  patches (B, NB, P, C) -> (B, NB, ET, C) = patches[pos]
  idx_dot_scatter: edges (B, NB, ET, C)  -> (B, NB, P, C) f32 sums by pos
Operands are cast to bf16 first, as the Pallas kernels did.  The gather
returns bf16: the Pallas kernel's f32 output held bf16 values exactly and
every caller cast it back to the compute dtype.  The scatter accumulates in
f32; callers fold the per-block sums with ops/blocked.patches_fold.

The positions travel in the step's BlockPlan (block_kernels.block_plan):
kernel D reads its positions, kernel E is the segment sum over its edges
sorted by patch site, bit-equal to its plain version on the CPU.  Each
op's gradient is the other op against the same plan, with the cotangent
cast to bf16 first (idx_kernels.py:146-162), and the result cast to the
primal's dtype.  Kernels D and E are csrc/block_kernels.cu's select
kernels (the .cu file has the design note); each wrapper takes its plain
PyTorch version only for a CPU tensor, and for a CUDA tensor launches its
kernel or raises.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import block_kernels as BK


def dot_gather_plain(pos: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel D (bf16 output)."""
    return BK.select_gather_plain(pos, patches.to(torch.bfloat16))


def dot_scatter_plain(plan: BK.BlockPlan, edges: torch.Tensor,
                      p_size: int) -> torch.Tensor:
    """Plain PyTorch version of kernel E (f32 output)."""
    return BK.plan_scatter_plain(plan, edges.to(torch.bfloat16), p_size)


def dot_gather(pos: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """Kernel D: (B, NB, ET) int32 x (B, NB, P, C) -> (B, NB, ET, C) bf16."""
    BK.check_select(pos, patches, "idx_dot_gather")
    patches = patches.to(torch.bfloat16)
    if patches.device.type == "cpu":
        return BK.select_gather_plain(pos, patches)
    out = BK.launch_gather(pos, patches, False, "idx_dot_gather")
    tracing.count("launch.idx_dot_gather")
    return out


def dot_scatter(plan: BK.BlockPlan, edges: torch.Tensor,
                p_size: int) -> torch.Tensor:
    """Kernel E: block plan x (B, NB, ET, C) -> (B, NB, P, C) f32."""
    BK.check_plan(plan, edges, p_size, "idx_dot_scatter")
    edges = edges.to(torch.bfloat16)
    if edges.device.type == "cpu":
        return BK.plan_scatter_plain(plan, edges, p_size)
    out = BK.launch_scatter(plan, edges, p_size, False, "idx_dot_scatter")
    tracing.count("launch.idx_dot_scatter")
    return out


class IdxDotGather(torch.autograd.Function):
    """patches -> patches[pos] (bf16); grad: kernel E on the bf16 cotangent."""

    @staticmethod
    def forward(ctx, plan, patches):
        ctx.save_for_backward(*plan)
        ctx.p_size, ctx.dtype = patches.shape[2], patches.dtype
        return dot_gather(plan.pos, patches.contiguous())

    @staticmethod
    def backward(ctx, ct):
        plan = BK.BlockPlan(*ctx.saved_tensors)
        d = dot_scatter(plan, ct.to(torch.bfloat16).contiguous(), ctx.p_size)
        return None, d.to(ctx.dtype)


class IdxDotScatter(torch.autograd.Function):
    """edges -> per-block sums (f32); grad: kernel D on the bf16 cotangent."""

    @staticmethod
    def forward(ctx, plan, edges, p_size):
        ctx.save_for_backward(plan.pos)
        ctx.dtype = edges.dtype
        return dot_scatter(plan, edges.contiguous(), p_size)

    @staticmethod
    def backward(ctx, ct):
        (pos,) = ctx.saved_tensors
        d = dot_gather(pos, ct.to(torch.bfloat16).contiguous())
        return None, d.to(ctx.dtype), None


def idx_dot_gather(plan: BK.BlockPlan, patches: torch.Tensor) -> torch.Tensor:
    """plan (block_plan of the (B, NB, ET) patch positions) x (B, NB, P, C)
    -> (B, NB, ET, C) bf16, differentiable in the patches."""
    return IdxDotGather.apply(plan, patches)


def idx_dot_scatter(plan: BK.BlockPlan, edges: torch.Tensor,
                    p_size: int) -> torch.Tensor:
    """plan x (B, NB, ET, C) -> (B, NB, P, C) f32 per-block sums (fold them
    with ops/blocked.patches_fold), differentiable in the edges."""
    return IdxDotScatter.apply(plan, edges, p_size)
