"""Kernels H and I: the mask-dot gather and scatter of the integer-mask
route (``--mask_dtype int8|int4``), their autograd pair, and the int4
packing.

Replace nbody_tpu/ops/pallas/mask_kernels.py : mask_dot_gather and
mask_dot_scatter (custom VJPs around ``_mask_dot_call``).  Per (batch,
core block), with the block's masks M (ET, P) from ops/blocked.block_masks:
  mask_dot_gather:  patches (B, NB, P, C) -> (B, NB, ET, C) f32 = M . patches
  mask_dot_scatter: edges (B, NB, ET, C)  -> (B, NB, P, C)  f32 = M^T . edges
The masks are int8 (B, NB, ET, P), or int4 packed two to a byte as uint8
(B, NB, ET, P/2): the entry of even column p in the low nibble, each
nibble a signed 4-bit value as jnp.int4 is (torch has no usable int4).
Both ops are dense products over whatever values the masks hold; the mask
is widened to bf16, the operand cast to bf16, and the products accumulate
in f32, as in the Pallas kernels.  Callers fold the scatter's per-block
sums with ops/blocked.patches_fold.

Each op's gradient is the other op against the same masks on the bf16
cotangent, cast to the primal's dtype; the masks get none
(mask_kernels.py:105-150).  JAX's ``group`` / ``set_group`` (blocks per
Pallas grid step, amortizing Mosaic's per-step cost on the TPU) is not
carried over: on the H100 a CTA per row tile of each block is the grain.
The row tiles of kernels H and I grow as C shrinks; ``gather_tiling``
and ``scatter_tiling`` choose them here and the C entries check them.
The kernels are csrc/mask_kernels.cu (the .cu file has the design note);
each wrapper takes its plain PyTorch version only for a CPU tensor, and
for a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import build

MASK_DTYPES = (torch.int8, torch.uint8)      # int8, packed int4
_INT_MAX = 2 ** 31 - 1

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "mask_dot_gather": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    "mask_dot_scatter": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P),
}


def library():
    """The built and loaded csrc/mask_kernels.cu (compiled at first use)."""
    return build.load("mask_kernels", _SIGNATURES)


# ---------------------------------------------------------------------------
# int4 packing
# ---------------------------------------------------------------------------

def pack_int4(values: torch.Tensor) -> torch.Tensor:
    """(..., P) integers in [-8, 7], P even -> (..., P/2) uint8: column 2j
    in the low nibble of byte j, 2j+1 in the high nibble (two's
    complement)."""
    if values.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last axis, got "
                         f"{values.shape[-1]}")
    v = values.to(torch.int16)
    if bool(((v < -8) | (v > 7)).any()):
        raise ValueError("int4 values must lie in [-8, 7]")
    v = v & 0xF
    return (v[..., 0::2] | (v[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., P/2) uint8 packed int4 -> (..., P) int8, sign-extended."""
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed int4 masks are uint8, got {packed.dtype}")
    v = packed.to(torch.int16)
    nib = torch.stack([v & 0xF, v >> 4], dim=-1)
    nib = nib - 16 * (nib >= 8).to(torch.int16)
    return nib.reshape(*packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def patch_width(masks: torch.Tensor) -> int:
    """P of int8 (…, P) or packed int4 (…, P/2) masks."""
    return masks.shape[-1] * (2 if masks.dtype == torch.uint8 else 1)


def widen(masks: torch.Tensor) -> torch.Tensor:
    """int8 or packed int4 masks -> f32 (B, NB, ET, P) (exact)."""
    m = unpack_int4(masks) if masks.dtype == torch.uint8 else masks
    return m.to(torch.float32)


# ---------------------------------------------------------------------------
# plain PyTorch versions (kernel semantics, used for CPU tensors)
# ---------------------------------------------------------------------------

def mask_dot_gather_plain(masks: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel H: f32 matmul of the widened masks
    and the bf16-rounded patches (exact products, f32 sums; TF32 must be
    off on a card)."""
    return torch.matmul(widen(masks), patches.to(torch.bfloat16).to(torch.float32))


def mask_dot_scatter_plain(masks: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel I."""
    return torch.matmul(widen(masks).transpose(-1, -2),
                        edges.to(torch.bfloat16).to(torch.float32))


# ---------------------------------------------------------------------------
# kernels H and I
# ---------------------------------------------------------------------------

def check_masks(masks: torch.Tensor, x: torch.Tensor, transpose: bool, name: str):
    """Shapes, types and devices of a (masks, patches|edges) pair; on CUDA
    also what the kernel takes."""
    if masks.dim() != 4 or x.dim() != 4 or x.shape[:2] != masks.shape[:2]:
        raise ValueError(f"{name}: bad shapes masks {tuple(masks.shape)}, "
                         f"operand {tuple(x.shape)}")
    if masks.dtype not in MASK_DTYPES:
        raise ValueError(f"{name}: masks must be int8 or packed int4 (uint8), "
                         f"got {masks.dtype}")
    rows = masks.shape[2] if transpose else patch_width(masks)
    if x.shape[2] != rows:
        raise ValueError(f"{name}: operand has {x.shape[2]} rows, the masks "
                         f"{rows}")
    if x.device != masks.device:
        raise ValueError(f"{name}: tensors on {x.device} and {masks.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")
    if x.device.type == "cuda" and not masks.is_contiguous():
        raise ValueError(f"{name} kernel takes contiguous masks")


def column_frags(c: int) -> int:
    """n8 column fragments of a CTA at C columns (64 a CTA at most; csrc/
    mask_kernels.cu: scatter_nt)."""
    w = min(c, 64)
    return 8 if w > 32 else 4 if w > 16 else 2 if w > 8 else 1


class ScatterTiling(NamedTuple):
    """Kernel I's tiling of one block's output (P, C): `row_tiles` CTAs of
    `warps` x `rows_per_warp` rows of P per 64 columns of C, `nt` n8
    column fragments each, and the ring's dynamic shared memory."""
    nt: int
    rows_per_warp: int
    warps: int
    row_tiles: int
    smem_bytes: int

    @property
    def rows(self) -> int:
        return self.warps * self.rows_per_warp


class ScatterCfg(NamedTuple):
    """Kernel I's ring per mask type and n8 column fragments (nt): rows of
    P a warp owns, edges per stage, stages, CTAs per SM the registers are
    cut for, warps per CTA at most (csrc/mask_kernels.cu: scatter_cfg)."""
    rows_per_warp: int
    edges: int
    stages: int
    min_blocks: int
    max_warps: int


def scatter_cfg(int4: bool, nt: int) -> ScatterCfg:
    if nt <= 2:
        return ScatterCfg(192, 32, 4, 2, 6)
    if int4:
        return ScatterCfg(64 if nt >= 8 else 128, 128, 2, 1, 10)
    if nt >= 8:
        return ScatterCfg(32, 64, 3, 1, 12)
    return ScatterCfg(64, 64, 3, 2, 8)


_MASK_PAD, _EDGE_PAD = 16, 8     # csrc/mask_kernels.cu: kMaskPad, kEdgePad
# f32 accumulators a thread of kernel H or I holds at most
SCATTER_ACC_REGS = GATHER_ACC_REGS = 128


def _split_rows(n: int, rows_per_warp: int, max_warps: int):
    """(warps, row tiles): the fewest row tiles of at most max_warps warps
    that cover n rows, with the warps split evenly over them."""
    tiles = -(-n // (max_warps * rows_per_warp))
    return -(-n // (tiles * rows_per_warp)), tiles


def scatter_tiling(p: int, c: int, int4: bool) -> ScatterTiling:
    """Kernel I's tiling at patch width P, C columns: row tiles of the
    configuration's warps (at most max_warps) split evenly over P (csrc/
    mask_kernels.cu: scatter_nt, scatter_cfg, scatter_smem_bytes)."""
    nt = column_frags(c)
    cfg = scatter_cfg(int4, nt)
    rw = cfg.rows_per_warp
    warps, tiles = _split_rows(p, rw, cfg.max_warps)
    tile_bytes = warps * rw // (2 if int4 else 1)
    smem = cfg.stages * cfg.edges * (tile_bytes + _MASK_PAD
                                     + 2 * (nt * 8 + _EDGE_PAD))
    return ScatterTiling(nt, rw, warps, tiles, smem)


class GatherCfg(NamedTuple):
    """Kernel H's ring per n8 column fragments (nt): rows of ET a consumer
    warp owns, stages, consumer warps per CTA at most (csrc/
    mask_kernels.cu: gather_cfg)."""
    rows_per_warp: int
    stages: int
    max_warps: int


def gather_cfg(nt: int) -> GatherCfg:
    return {1: GatherCfg(128, 2, 13), 2: GatherCfg(128, 3, 8),
            4: GatherCfg(128, 3, 7)}.get(nt, GatherCfg(64, 4, 7))


class GatherTiling(NamedTuple):
    """Kernel H's tiling of one block's output (ET, C): `row_tiles` tiles
    of `warps` consumer warps x `rows_per_warp` rows of ET per 64 columns
    of C, `nt` n8 column fragments each; the ring's stages (GATHER_SPAN
    mask bytes of each row) and its dynamic shared memory."""
    nt: int
    rows_per_warp: int
    warps: int
    row_tiles: int
    stages: int
    smem_bytes: int

    @property
    def rows(self) -> int:
        return self.warps * self.rows_per_warp


_SMEM_ALIGN = 1024               # csrc/mask_kernels.cu: kSmemAlign
GATHER_SPAN = 64                 # csrc/mask_kernels.cu: kGatherSpan


def gather_ldx(nt: int) -> int:
    """bf16 per row of kernel H's patch tile (csrc/mask_kernels.cu)."""
    return max(nt, 2) * 8 + 8


def gather_tiling(et: int, c: int, int4: bool) -> GatherTiling:
    """Kernel H's tiling at ET mask rows, C columns: row tiles of the
    configuration's warps (at most max_warps) split evenly over ET (csrc/
    mask_kernels.cu: gather_cfg, gather_smem_bytes)."""
    nt = column_frags(c)
    cfg = gather_cfg(nt)
    rw = cfg.rows_per_warp
    warps, tiles = _split_rows(et, rw, cfg.max_warps)
    patch_rows = GATHER_SPAN * (2 if int4 else 1)
    smem = _SMEM_ALIGN + cfg.stages * (warps * rw * GATHER_SPAN
                                       + patch_rows * gather_ldx(nt) * 2 + 16)
    return GatherTiling(nt, rw, warps, tiles, cfg.stages, smem)


def _out(masks, x, rows):
    b, nb = masks.shape[:2]
    return torch.empty((b, nb, rows, x.shape[3]), dtype=torch.float32,
                       device=x.device)


def dot_gather(masks: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """Kernel H: (B, NB, ET, P|P/2) masks x (B, NB, P, C) -> (B, NB, ET, C)
    f32."""
    check_masks(masks, patches, False, "mask_dot_gather")
    patches = patches.to(torch.bfloat16)
    if patches.device.type == "cpu":
        return mask_dot_gather_plain(masks, patches)
    b, nb, et = masks.shape[:3]
    p, c = patch_width(masks), patches.shape[3]
    int4 = masks.dtype == torch.uint8
    tl = gather_tiling(max(et, 1), c, int4)
    # the tensor map's row coordinate is an int
    if b * nb * et > _INT_MAX:
        raise ValueError("mask_dot_gather: too large for one launch")
    patches = patches.contiguous()
    out = _out(masks, patches, et)
    dev = patches.device.index
    err = library().mask_dot_gather(
        masks.data_ptr(), patches.data_ptr(), out.data_ptr(), b * nb, et, p, c,
        int(int4), tl.nt, tl.rows_per_warp, tl.warps, tl.row_tiles,
        tl.stages, tl.smem_bytes, dev, build.stream(dev))
    build.check_launch(err, "mask_dot_gather")
    tracing.count("launch.mask_dot_gather")
    return out


def dot_scatter(masks: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Kernel I: masks x (B, NB, ET, C) -> (B, NB, P, C) f32."""
    check_masks(masks, edges, True, "mask_dot_scatter")
    edges = edges.to(torch.bfloat16)
    if edges.device.type == "cpu":
        return mask_dot_scatter_plain(masks, edges)
    b, nb, et = masks.shape[:3]
    p, c = patch_width(masks), edges.shape[3]
    int4 = masks.dtype == torch.uint8
    tl = scatter_tiling(max(p, 1), c, int4)
    if b * nb * tl.row_tiles > _INT_MAX or c > 64 * 65535:
        raise ValueError("mask_dot_scatter: too large for one launch")
    edges = edges.contiguous()
    out = _out(masks, edges, p)
    dev = edges.device.index
    err = library().mask_dot_scatter(
        masks.data_ptr(), edges.data_ptr(), out.data_ptr(), b * nb, et, p, c,
        int(int4), tl.nt, tl.rows_per_warp, tl.warps, tl.row_tiles,
        tl.smem_bytes, dev, build.stream(dev))
    build.check_launch(err, "mask_dot_scatter")
    tracing.count("launch.mask_dot_scatter")
    return out


class MaskDotGather(torch.autograd.Function):
    """patches -> M . patches (f32); grad: kernel I on the bf16 cotangent."""

    @staticmethod
    def forward(ctx, masks, patches):
        ctx.save_for_backward(masks)
        ctx.dtype = patches.dtype
        return dot_gather(masks, patches)

    @staticmethod
    def backward(ctx, ct):
        (masks,) = ctx.saved_tensors
        return None, dot_scatter(masks, ct.to(torch.bfloat16)).to(ctx.dtype)


class MaskDotScatter(torch.autograd.Function):
    """edges -> M^T . edges (f32); grad: kernel H on the bf16 cotangent."""

    @staticmethod
    def forward(ctx, masks, edges):
        ctx.save_for_backward(masks)
        ctx.dtype = edges.dtype
        return dot_scatter(masks, edges)

    @staticmethod
    def backward(ctx, ct):
        (masks,) = ctx.saved_tensors
        return None, dot_gather(masks, ct.to(torch.bfloat16)).to(ctx.dtype)


def mask_dot_gather(masks: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """(B, NB, ET, P) int8 or (B, NB, ET, P/2) packed int4 masks x
    (B, NB, P, C) -> (B, NB, ET, C) f32, differentiable in the patches."""
    return MaskDotGather.apply(masks, patches)


def mask_dot_scatter(masks: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """masks x (B, NB, ET, C) -> (B, NB, P, C) f32 per-block sums (fold
    them with ops/blocked.patches_fold), differentiable in the edges."""
    return MaskDotScatter.apply(masks, edges)
