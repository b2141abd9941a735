"""Kernels F and G: the 3D-block gather and scatter (wrappers of
csrc/block_kernels.cu), and the launch helpers kernels D and E share.

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
is dropped.  The scatter accumulates in f32 in shared memory; the order of
its atomics varies from run to run (tolerance in the .cu file's note).

On the H100 both are memory-bound; each CTA stages one block's patch tile
(gather) or f32 accumulator (scatter) in shared memory, so device memory
sees each element once and the scatter needs no global atomics.

Each wrapper takes its plain PyTorch version only for a CPU tensor; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from nbody_tpu_torch.ops.kernels import build

# launches of the CUDA kernels in this process (reset by callers that count)
LAUNCHES = {"block_gather": 0, "block_scatter": 0}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# shared memory one CTA stages.  Two gather CTAs fit an SM's 228 KB, whose
# wider tiles beat a third CTA; the scatter, with a busier inner loop,
# keeps three (both measured on an H100 at the 64^3 index shapes)
GATHER_SMEM = 113 * 1024
SCATTER_SMEM = 96 * 1024
_INT_MAX = 2 ** 31 - 1

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "block_select_gather": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "block_select_scatter": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "block_select_max_smem": (_I,),
}


def library():
    """The built and loaded csrc/block_kernels.cu (compiled at first use)."""
    return build.load("block_kernels", _SIGNATURES)


def c_tile(p: int, c: int, elem_bytes: int, budget: int) -> int:
    """Channels per CTA: C split into the fewest equal tiles whose
    (P, tile) shared-memory array fits `budget` bytes (at least 1 channel)."""
    ct_max = max(1, budget // (p * elem_bytes))
    tiles = -(-c // ct_max)
    return -(-c // tiles)


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


def select_scatter_plain(pos: torch.Tensor, vals: torch.Tensor,
                         p_size: int) -> torch.Tensor:
    """(B, NB, ET) x (B, NB, ET, C) -> (B, NB, P, C) sums by position in
    f32 (f64 for f64 input); positions outside [0, P) are dropped."""
    b, nb, _, c = vals.shape
    acc_dt = torch.promote_types(vals.dtype, torch.float32)
    valid = (pos >= 0) & (pos < p_size)
    ids = torch.where(valid, pos, p_size).long()     # row P: a sink, dropped
    acc = torch.zeros((b, nb, p_size + 1, c), dtype=acc_dt, device=vals.device)
    acc.scatter_add_(2, ids[..., None].expand(*ids.shape, c), vals.to(acc_dt))
    return acc[:, :, :p_size]


def _round_if(x: torch.Tensor, fast: bool) -> torch.Tensor:
    """The Pallas fast mode: f32 operands rounded to bf16 (kept in f32)."""
    if fast and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def block_gather_plain(p: torch.Tensor, patches: torch.Tensor,
                       fast: bool = True) -> torch.Tensor:
    """Plain PyTorch version of kernel F."""
    return select_gather_plain(p, _round_if(patches, fast))


def block_scatter_plain(p: torch.Tensor, vals: torch.Tensor, p_size: int,
                        fast: bool = True) -> torch.Tensor:
    """Plain PyTorch version of kernel G."""
    return select_scatter_plain(p, _round_if(vals, fast), p_size)


# ---------------------------------------------------------------------------
# CUDA launches (shared with kernels D and E, ops/kernels/idx_kernels.py)
# ---------------------------------------------------------------------------

def check_select(pos: torch.Tensor, x: torch.Tensor, name: str):
    """Shapes, types and devices of a (pos, patches|vals) pair; on CUDA
    also what the kernel takes."""
    if pos.dim() != 3 or x.dim() != 4 or x.shape[:2] != pos.shape[:2]:
        raise ValueError(f"{name}: bad shapes pos {tuple(pos.shape)}, "
                         f"operand {tuple(x.shape)}")
    if pos.dtype != torch.int32:
        raise ValueError(f"{name}: positions must be int32, got {pos.dtype}")
    if x.device != pos.device:
        raise ValueError(f"{name}: tensors on {x.device} and {pos.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")
    if x.device.type == "cuda":
        if x.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name} kernel takes float32 or bfloat16, "
                             f"got {x.dtype}")
        if not (x.is_contiguous() and pos.is_contiguous()):
            raise ValueError(f"{name} kernel takes contiguous tensors")


def vector_width(c: int, elem_bytes: int, *ptrs: int) -> int:
    """Channels per access: the widest of 16, 8, 4 or 2 bytes whose
    element count divides C and to which every buffer is aligned."""
    for nbytes in (16, 8, 4, 2):
        v = nbytes // elem_bytes
        if v >= 1 and c % v == 0 and all(q % nbytes == 0 for q in ptrs):
            return v
    return 1


def _tiling(p: int, c: int, tile_elem: int, vec: int, budget: int,
            device: torch.device, name: str) -> int:
    """Channels per CTA: c_tile over vectors of `vec` channels, checked
    against the card's shared memory (tile elements of tile_elem bytes)."""
    ct = c_tile(p, c // vec, tile_elem * vec, budget) * vec
    limit = library().block_select_max_smem(device.index)
    if p * ct * tile_elem > limit:
        raise ValueError(f"{name}: a patch of {p} sites needs "
                         f"{p * ct * tile_elem} bytes of shared memory, "
                         f"over the card's {limit}")
    return ct


def _check_size(name: str, *counts: int):
    if max(counts) > _INT_MAX:
        raise ValueError(f"{name}: too large for one launch")


def launch_gather(pos: torch.Tensor, patches: torch.Tensor, round_bf16: bool,
                  name: str) -> torch.Tensor:
    """The gather kernel on CUDA tensors -> (B, NB, ET, C), patches' dtype."""
    b, nb, p, c = patches.shape
    et = pos.shape[2]
    _check_size(name, b * nb, p * c, et * c)
    out = torch.empty((b, nb, et, c), dtype=patches.dtype, device=patches.device)
    elem = patches.element_size()
    vec = vector_width(c, elem, patches.data_ptr(), out.data_ptr())
    ct = _tiling(p, c, elem, vec, GATHER_SMEM, patches.device, name)
    err = library().block_select_gather(
        patches.data_ptr(), pos.data_ptr(), out.data_ptr(), b * nb, p, et, c,
        ct, vec, int(patches.dtype == torch.bfloat16), int(round_bf16),
        patches.device.index,
        torch.cuda.current_stream(patches.device).cuda_stream)
    build.check_launch(err, f"block_select_gather ({name})")
    return out


def launch_scatter(pos: torch.Tensor, vals: torch.Tensor, p_size: int,
                   round_bf16: bool, name: str) -> torch.Tensor:
    """The scatter kernel on CUDA tensors -> (B, NB, P, C) f32."""
    b, nb, et, c = vals.shape
    _check_size(name, b * nb, p_size * c, et * c)
    out = torch.empty((b, nb, p_size, c), dtype=torch.float32, device=vals.device)
    vec = vector_width(c, vals.element_size(), vals.data_ptr())
    ct = _tiling(p_size, c, 4, vec, SCATTER_SMEM, vals.device, name)
    err = library().block_select_scatter(
        vals.data_ptr(), pos.data_ptr(), out.data_ptr(), b * nb, p_size, et, c,
        ct, vec, int(vals.dtype == torch.bfloat16), int(round_bf16),
        vals.device.index, torch.cuda.current_stream(vals.device).cuda_stream)
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
    LAUNCHES["block_gather"] += 1
    return out


def block_scatter(p: torch.Tensor, vals: torch.Tensor, p_size: int,
                  fast: bool = True) -> torch.Tensor:
    """p (B, NB, ET) int32, vals (B, NB, ET, C) -> per-block sums
    (B, NB, P, C) f32 (p_size = P)."""
    check_select(p, vals, "block_scatter")
    if vals.device.type == "cpu":
        return block_scatter_plain(p, vals, p_size, fast)
    out = launch_scatter(p, vals, p_size,
                         fast and vals.dtype == torch.float32, "block_scatter")
    LAUNCHES["block_scatter"] += 1
    return out
