"""Kernels F and G: the 3D-block gather and scatter (wrappers of
csrc/block_kernels.cu), the block plan the scatters run over, and the
launch helpers kernels D and E share.

Replace nbody_tpu/ops/pallas/block_kernels.py : block_gather_pallas and
block_scatter_pallas.  Per (batch, core block), with p (B, NB, ET) int32
positions into the block's dilated patch of P sites:
  block_gather:  (B, NB, P, C)  -> (B, NB, ET, C) = patches[p]
  block_scatter: (B, NB, ET, C) -> (B, NB, P, C)  f32 sums by position
The gather returns the patches' dtype: the Pallas kernel's f32 output of
bf16 operands held bf16 values exactly.
``fast`` is the Pallas switch: f32 operands are rounded to bf16 (round to
nearest even) before the copy or the add; bf16 operands are unchanged, so
fast mode is exact on bf16 input.  A position outside [0, P) reads 0 and
is dropped.

The scatters (E and G) are a segment sum over a ``BlockPlan`` -- the
positions with the flat edge ids sorted by patch site, ties by ascending
edge id, and each site's offsets -- built once per step (``block_plan``,
plain torch: index bookkeeping, not a kernel of the TPU package).  They
accumulate in f32 in ascending edge order: bit-equal to their plain
versions on the CPU, whose index_add_ adds in the same order.

On the H100 both are memory-bound; the gather's threads store 16-byte
vectors of the output at every width and read the patches through L2, the
scatter's threads own output rows (design note in the .cu file).  The
gather's tiling (``gather_tiling``) is chosen here and checked in C.

Each wrapper takes its plain PyTorch version only for a CPU tensor; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import build
from nbody_tpu_torch.ops.kernels.banded_kernels import (plan_sum_plain,
                                                        sorted_segments)

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "block_select_gather": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "block_select_scatter": (_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _P),
}


def library():
    """The built and loaded csrc/block_kernels.cu (compiled at first use)."""
    return build.load("block_kernels", _SIGNATURES)


class BlockPlan(NamedTuple):
    """A step's per-edge patch positions and the edges sorted by patch
    site, shared by every selection of the step (the per-block
    counterpart of banded_kernels.GraphPlan).

    pos:     (B, NB, ET) int32 position of each edge in its block's patch
             of P sites (the gathers D and F read it).
    order:   (B*NB*ET,) int32 flat edge ids blk*ET + e (blk = b*NB + n),
             sorted by site key blk*P + pos, ties by ascending edge id;
             edges whose position lies outside [0, P) come last, past
             offsets[-1].
    offsets: (B*NB*P + 1,) int32; site s's edges are order[offsets[s]:
             offsets[s + 1]] (the scatters E and G run over them)."""
    pos: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor

    def site_degree(self) -> torch.Tensor:
        """(B, NB, P) int32 edges per patch site."""
        b, nb, _ = self.pos.shape
        return (self.offsets[1:] - self.offsets[:-1]).reshape(b, nb, -1)


@torch.no_grad()
def block_plan(pos: torch.Tensor, p_size: int) -> BlockPlan:
    """pos (B, NB, ET) int32 -> its BlockPlan over patches of p_size
    sites: sorted_segments of the int32 site keys blk*P + pos."""
    b, nb, et = pos.shape
    if pos.dtype != torch.int32:
        raise ValueError(f"block_plan: positions must be int32, got {pos.dtype}")
    if max(b * nb * et, b * nb * p_size) > _INT_MAX:
        raise ValueError(f"block_plan: {b * nb * et} edges or "
                         f"{b * nb * p_size} sites exceed int32 ids")
    base = torch.arange(b * nb, dtype=torch.int32,
                        device=pos.device).reshape(b, nb, 1) * p_size
    valid = (pos >= 0) & (pos < p_size)
    keys = torch.where(valid, pos + base, b * nb * p_size).reshape(-1)
    return BlockPlan(pos, *sorted_segments(keys, b * nb * p_size))


GATHER_THREADS = 256     # csrc/block_kernels.cu: kGatherThreads
GATHER_PER_THREAD = 4    # accesses a gather thread makes at most
ROWS, FLAT, SCALAR = 0, 1, 2   # the gather's access paths (csrc: Path)


class GatherTiling(NamedTuple):
    """Kernels D and F's launch: the access `path` (ROWS: 16-byte pieces
    of patch rows, at C a multiple of the 16-byte vector; FLAT: 16-byte
    vectors of the block's contiguous (ET, C) output assembled element by
    element; SCALAR: one element an access) and `chunks` CTAs of
    GATHER_THREADS per block, each thread making at most GATHER_PER_THREAD
    accesses."""
    path: int
    chunks: int


def gather_tiling(et: int, c: int, elem: int, patches_aligned: bool,
                  out_aligned: bool) -> GatherTiling:
    """Kernels D and F's launch at ET edges, C channels of `elem` bytes
    (csrc/block_kernels.cu checks it): 16-byte accesses wherever the shapes
    and the buffers' 16-byte alignment allow them -- at every path's
    width -- and as many CTAs per block as GATHER_PER_THREAD accesses a
    thread need."""
    v = 16 // elem
    if c % v == 0 and patches_aligned and out_aligned:
        path = ROWS
    elif et * c % v == 0 and out_aligned:
        path = FLAT
    else:
        path, v = SCALAR, 1
    per_cta = GATHER_THREADS * GATHER_PER_THREAD
    return GatherTiling(path, max(1, -(-(et * c // v) // per_cta)))


# ---------------------------------------------------------------------------
# plain PyTorch versions (kernel semantics, used for CPU tensors)
# ---------------------------------------------------------------------------

def select_gather_plain(pos: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """(B, NB, ET) x (B, NB, P, C) -> (B, NB, ET, C) = patches[pos] in the
    patches' dtype; 0 where pos is outside [0, P)."""
    p, c = patches.shape[2], patches.shape[3]
    valid = (pos >= 0) & (pos < p)
    ids = torch.where(valid, pos, 0).long()
    out = torch.gather(patches, 2, ids[..., None].expand(*ids.shape, c))
    return torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype))


def plan_scatter_plain(plan: BlockPlan, vals: torch.Tensor,
                       p_size: int) -> torch.Tensor:
    """(B, NB, ET, C) -> (B, NB, P, C) sums by patch site in f32 (f64 for
    f64 input): plan_sum_plain over the plan's flat (B*NB*P, C) rows, in
    ascending edge order; positions outside [0, P) are dropped."""
    b, nb, _, c = vals.shape
    return plan_sum_plain(vals.reshape(-1, c), plan.order,
                          plan.offsets).reshape(b, nb, p_size, c)


def _round_if(x: torch.Tensor, fast: bool) -> torch.Tensor:
    """The Pallas fast mode: f32 operands rounded to bf16 (kept in f32)."""
    if fast and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def block_gather_plain(p: torch.Tensor, patches: torch.Tensor,
                       fast: bool = True) -> torch.Tensor:
    """Plain PyTorch version of kernel F."""
    return select_gather_plain(p, _round_if(patches, fast))


def block_scatter_plain(plan: BlockPlan, vals: torch.Tensor, p_size: int,
                        fast: bool = True) -> torch.Tensor:
    """Plain PyTorch version of kernel G."""
    return plan_scatter_plain(plan, _round_if(vals, fast), p_size)


# ---------------------------------------------------------------------------
# CUDA launches (shared with kernels D and E, ops/kernels/idx_kernels.py)
# ---------------------------------------------------------------------------

def _check_devices(name: str, x: torch.Tensor, *others: torch.Tensor):
    """x and `others` on one device, the CPU or a card; on a card, what the
    kernels take (x float32 or bfloat16, every tensor contiguous)."""
    dev = x.device
    if any(t.device != dev for t in others):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in (x, *others)]}")
    if dev.type == "cuda":
        if x.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name} kernel takes float32 or bfloat16, "
                             f"got {x.dtype}")
        if not all(t.is_contiguous() for t in (x, *others)):
            raise ValueError(f"{name} kernel takes contiguous tensors")
    elif dev.type != "cpu":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {dev}")


def check_select(pos: torch.Tensor, x: torch.Tensor, name: str):
    """Shapes, types and devices of a (pos, patches|vals) pair; on CUDA
    also what the kernel takes."""
    if pos.dim() != 3 or x.dim() != 4 or x.shape[:2] != pos.shape[:2]:
        raise ValueError(f"{name}: bad shapes pos {tuple(pos.shape)}, "
                         f"operand {tuple(x.shape)}")
    if pos.dtype != torch.int32:
        raise ValueError(f"{name}: positions must be int32, got {pos.dtype}")
    _check_devices(name, x, pos)


def check_plan(plan: BlockPlan, vals: torch.Tensor, p_size: int, name: str):
    """The plan against vals (B, NB, ET, C) and p_size, as check_select
    checks a (pos, vals) pair: a plan that does not fit raises."""
    pos, order, offsets = plan
    if vals.dim() != 4 or pos.shape != vals.shape[:3]:
        raise ValueError(f"{name}: bad shapes pos {tuple(pos.shape)}, "
                         f"operand {tuple(vals.shape)}")
    b, nb, et, _ = vals.shape
    if order.shape != (b * nb * et,) or offsets.shape != (b * nb * p_size + 1,):
        raise ValueError(f"{name}: plan (pos {tuple(pos.shape)}, order "
                         f"{tuple(order.shape)}, offsets {tuple(offsets.shape)}) "
                         f"does not fit vals {tuple(vals.shape)} with P={p_size}")
    if not pos.dtype == order.dtype == offsets.dtype == torch.int32:
        raise ValueError(f"{name}: the plan's tensors must be int32")
    _check_devices(name, vals, pos, order, offsets)


def vector_width(c: int, elem_bytes: int, *ptrs: int) -> int:
    """Channels per access: the widest of 16, 8, 4 or 2 bytes whose
    element count divides C and to which every buffer is aligned."""
    for nbytes in (16, 8, 4, 2):
        v = nbytes // elem_bytes
        if v >= 1 and c % v == 0 and all(q % nbytes == 0 for q in ptrs):
            return v
    return 1


def _check_size(name: str, *counts: int):
    if max(counts) > _INT_MAX:
        raise ValueError(f"{name}: too large for one launch")


def launch_gather(pos: torch.Tensor, patches: torch.Tensor, round_bf16: bool,
                  name: str) -> torch.Tensor:
    """The gather kernel on CUDA tensors -> (B, NB, ET, C), patches' dtype."""
    b, nb, p, c = patches.shape
    et = pos.shape[2]
    _check_size(name, b * nb, p * c, et * c)
    out = patches.new_empty((b, nb, et, c))
    tl = gather_tiling(et, c, patches.element_size(), patches.data_ptr() % 16 == 0,
                       out.data_ptr() % 16 == 0)
    _check_size(name, b * nb * tl.chunks)
    dev = patches.get_device()
    err = library().block_select_gather(
        patches.data_ptr(), pos.data_ptr(), out.data_ptr(), b * nb, p, et, c,
        tl.path, tl.chunks, int(patches.dtype == torch.bfloat16),
        int(round_bf16), dev, build.stream(dev))
    build.check_launch(err, f"block_select_gather ({name})")
    return out


def launch_scatter(plan: BlockPlan, vals: torch.Tensor, p_size: int,
                   round_bf16: bool, name: str) -> torch.Tensor:
    """The segment-sum kernel on CUDA tensors -> (B, NB, P, C) f32.  The
    output is fresh (512-byte aligned) and its rows are C * 4 bytes, so
    the vector width that fits vals fits it too."""
    b, nb, et, c = vals.shape
    out = vals.new_empty((b, nb, p_size, c), dtype=torch.float32)
    dev = vals.get_device()
    err = library().block_select_scatter(
        vals.data_ptr(), plan.order.data_ptr(), plan.offsets.data_ptr(),
        out.data_ptr(), b * nb * p_size, b * nb * et, c,
        vector_width(c, vals.element_size(), vals.data_ptr()),
        int(vals.dtype == torch.bfloat16), int(round_bf16), dev,
        build.stream(dev))
    build.check_launch(err, f"block_select_scatter ({name})")
    return out


# ---------------------------------------------------------------------------
# kernels F and G
# ---------------------------------------------------------------------------

def block_gather(p: torch.Tensor, patches: torch.Tensor,
                 fast: bool = True) -> torch.Tensor:
    """p (B, NB, ET) int32, patches (B, NB, P, C) -> (B, NB, ET, C) in the
    patches' dtype."""
    check_select(p, patches, "block_gather")
    if patches.device.type == "cpu":
        return block_gather_plain(p, patches, fast)
    out = launch_gather(p, patches, fast and patches.dtype == torch.float32,
                        "block_gather")
    tracing.count("launch.block_gather")
    return out


def block_scatter(plan: BlockPlan, vals: torch.Tensor, p_size: int,
                  fast: bool = True) -> torch.Tensor:
    """plan (block_plan of the (B, NB, ET) positions), vals (B, NB, ET, C)
    -> per-block sums (B, NB, P, C) f32 (p_size = P)."""
    check_plan(plan, vals, p_size, "block_scatter")
    if vals.device.type == "cpu":
        return block_scatter_plain(plan, vals, p_size, fast)
    out = launch_scatter(plan, vals, p_size,
                         fast and vals.dtype == torch.float32, "block_scatter")
    tracing.count("launch.block_scatter")
    return out
