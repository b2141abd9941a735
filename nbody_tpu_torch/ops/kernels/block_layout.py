"""The masked route's block layout (wrapper of csrc/block_layout.cu):
block_patches and patches_fold, with their plain PyTorch versions.

  block_patches: (B, N, C)      -> (B, NB, P, C)  each core block's dilated
                                   patch of the periodic cube, an exact copy
  patches_fold:  (B, NB, P, C)  -> (B, N, C)      its transpose: the
                                   per-block sums folded back into the cube

N = cells^3 rows in z-major order, NB core blocks of the core (bx, by,
bz), P = (bx + 2w)(by + 2w)(bz + 2w) patch sites in (lx, ly, lz) order
for the lattice window w (ops/blocked.py has the layout).  The plain
versions are the eager port of the JAX package's ops (the wrap pad and
strided windows; the strided slice-adds z, then y, then x into the padded
cube and the pad rings folded back axis by axis), so patches_fold_plain
adds in the JAX package's order.  The fold kernel computes each cube row's
sum in that same association tree, rounding every bf16 add as torch's bf16
add does: its f32 and bf16 results equal patches_fold_plain's bit for bit
(the .cu file has the design note).

Each wrapper takes its plain version only for a CPU tensor; for a CUDA
tensor it launches its kernel on PyTorch's current stream, into a
torch.empty output, or raises ValueError for input the kernel does not
take (``check_patches``, ``check_fold``): shapes that do not match the
geometry, a cube under two windows a side (where the pad rings would
overlap), and for the fold a dtype other than f32 or bf16.  Each launch
counts ``launch.block_patches`` or ``launch.patches_fold``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import build

FOLD_DTYPES = (torch.float32, torch.bfloat16)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "block_patches_forward": (_P, _P, _L, _L) + (_I,) * 9 + (_P,),
    "patches_fold_forward": (_P, _P, _L) + (_I,) * 10 + (_P,),
}
# threads a block (csrc: kThreads), and the bytes a block of the build
# kernel aims to copy
_THREADS = 256
_BLOCK_BYTES = 16384


def library():
    """The built and loaded csrc/block_layout.cu (compiled at first use)."""
    return build.load("block_layout", _SIGNATURES)


def block_geometry(cells: int, window: int, core: Sequence[int]):
    """-> ((nbx, nby, nbz) blocks per axis, (ex, ey, ez) patch extents)."""
    bx, by, bz = core
    if cells % bx or cells % by or cells % bz:
        raise ValueError(f"core {tuple(core)} does not tile a {cells}^3 cube")
    nb = (cells // bx, cells // by, cells // bz)
    ext = (bx + 2 * window, by + 2 * window, bz + 2 * window)
    return nb, ext


# ---------------------------------------------------------------- plain

def _wrap_pad(grid: torch.Tensor, w: int) -> torch.Tensor:
    """(B, c, c, c, C) -> circularly padded (B, c+2w, c+2w, c+2w, C)
    (jnp.pad mode="wrap")."""
    cells = grid.shape[1]
    ids = torch.remainder(torch.arange(-w, cells + w, device=grid.device), cells)
    for axis in (1, 2, 3):
        grid = grid.index_select(axis, ids)
    return grid


def block_patches_plain(values: torch.Tensor, cells: int, window: int,
                        core: Sequence[int]) -> torch.Tensor:
    """The patches as strided windows (unfold) of the padded cube; the
    final reshape is the one copy."""
    b, _, c = values.shape
    bx, by, bz = core
    (nbx, nby, nbz), (ex, ey, ez) = block_geometry(cells, window, core)
    padded = _wrap_pad(values.reshape(b, cells, cells, cells, c), window)
    u = padded.unfold(1, ex, bx).unfold(2, ey, by).unfold(3, ez, bz)
    # (B, nbx, nby, nbz, C, ex, ey, ez) -> (B, nbx, nby, nbz, ex, ey, ez, C)
    u = u.permute(0, 1, 2, 3, 5, 6, 7, 4)
    return u.reshape(b, nbx * nby * nbz, ex * ey * ez, c)


def patches_fold_plain(acc: torch.Tensor, cells: int, window: int,
                       core: Sequence[int]) -> torch.Tensor:
    """The fold in acc's dtype: z, then y, then x strided slice-adds into
    zero-filled padded buffers, then the pad rings folded back axis by
    axis (the JAX package's order of adds)."""
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


# ---------------------------------------------------------------- checks

def _check_geometry(name: str, cells: int, window: int, core: Sequence[int]):
    if len(core) != 3 or min(core) < 1 or window < 0 or cells < 2 * window:
        raise ValueError(f"{name}: the kernel takes a core of three positive "
                         f"sides and 0 <= window <= cells / 2, got core "
                         f"{tuple(core)}, window {window}, cells {cells}")
    block_geometry(cells, window, core)


def check_patches(values: torch.Tensor, cells: int, window: int,
                  core: Sequence[int]):
    """Raise ValueError unless the build kernel takes these arguments:
    values (B, cells^3, C) and a geometry as _check_geometry asks."""
    _check_geometry("block_patches", cells, window, core)
    if values.dim() != 3 or values.shape[1] != cells ** 3:
        raise ValueError(f"block_patches: values must be (B, {cells ** 3}, C), "
                         f"got {tuple(values.shape)}")


def check_fold(acc: torch.Tensor, cells: int, window: int,
               core: Sequence[int]):
    """Raise ValueError unless the fold kernel takes these arguments: acc
    (B, NB, P, C) of the geometry, f32 or bf16."""
    _check_geometry("patches_fold", cells, window, core)
    (nbx, nby, nbz), (ex, ey, ez) = block_geometry(cells, window, core)
    want = (nbx * nby * nbz, ex * ey * ez)
    if acc.dim() != 4 or tuple(acc.shape[1:3]) != want:
        raise ValueError(f"patches_fold: acc must be (B, {want[0]}, {want[1]}, "
                         f"C), got {tuple(acc.shape)}")
    if acc.dtype not in FOLD_DTYPES:
        raise ValueError(f"patches_fold kernel takes float32 or bfloat16, got "
                         f"{acc.dtype}")


# ---------------------------------------------------------------- kernels

def vec_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The build kernel's access: the widest of 16, 8, 4, 2, 1 bytes
    dividing the row and every buffer's address."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    return 1


def vec_elements(c: int, *tensors: torch.Tensor) -> int:
    """The fold kernel's elements per access: the widest of 16 bytes, 4, 2,
    1 elements dividing the width and every buffer's alignment."""
    es = tensors[0].element_size()
    for v in (16 // es, 4, 2):
        if c % v == 0 and all(t.data_ptr() % (v * es) == 0 for t in tensors):
            return v
    return 1


def build_tiling(units: int, row_bytes: int, p_size: int):
    """The build kernel's (lanes, sites): a thread a vector of a row, up to
    a block's 256 threads a row, and as many sites a thread as let a block
    copy about 16 KiB of a patch."""
    lanes = min(units, _THREADS)
    rows = _THREADS // lanes
    sites = min(-(-p_size // rows), _BLOCK_BYTES // (rows * row_bytes))
    return lanes, max(1, sites)


def fold_lanes(units: int, vec_bytes: int) -> int:
    """The fold kernel's threads a row: a thread a vector (up to 256) where
    the row is read in 16-byte vectors or has more than 16, else one
    thread, which then walks the row's tree of entries once for all of
    its vectors (measured faster at C 3, 6 and 9)."""
    return min(units, _THREADS) if vec_bytes == 16 or units > 16 else 1


def _launch_patches(values, cells, window, core):
    b, _, c = values.shape
    (nbx, nby, nbz), (ex, ey, ez) = block_geometry(cells, window, core)
    out = torch.empty((b, nbx * nby * nbz, ex * ey * ez, c), dtype=values.dtype,
                      device=values.device)
    if out.numel() == 0:
        return out
    row = c * values.element_size()
    vb = vec_bytes(row, values, out)
    dev = values.device.index
    err = library().block_patches_forward(
        values.data_ptr(), out.data_ptr(), b, row, vb,
        *build_tiling(row // vb, row, ex * ey * ez), cells, window, *core, dev,
        build.stream(dev))
    build.check_launch(err, "block_patches_forward")
    tracing.count("launch.block_patches")
    return out


def _launch_fold(acc, cells, window, core):
    b, c = acc.shape[0], acc.shape[3]
    out = torch.empty((b, cells ** 3, c), dtype=acc.dtype, device=acc.device)
    vec = vec_elements(c, acc, out)
    dev = acc.device.index
    err = library().patches_fold_forward(
        acc.data_ptr(), out.data_ptr(), b, c, vec,
        fold_lanes(c // vec, vec * acc.element_size()),
        int(acc.dtype == torch.bfloat16), cells, window, *core, dev,
        build.stream(dev))
    build.check_launch(err, "patches_fold_forward")
    tracing.count("launch.patches_fold")
    return out


def block_patches(values: torch.Tensor, cells: int, window: int,
                  core: Sequence[int]) -> torch.Tensor:
    """(B, N, C) -> (B, NB, P, C) in values' dtype: block_patches_plain on a
    CPU tensor, else the build kernel (any dtype: it copies bytes)."""
    if values.device.type == "cpu":
        return block_patches_plain(values, cells, window, core)
    check_patches(values, cells, window, core)
    return _launch_patches(values.contiguous(), cells, window, tuple(core))


def patches_fold(acc: torch.Tensor, cells: int, window: int,
                 core: Sequence[int]) -> torch.Tensor:
    """(B, NB, P, C) -> (B, N, C) in acc's dtype: patches_fold_plain on a
    CPU tensor, else the fold kernel (f32 or bf16), bit-equal to it."""
    if acc.device.type == "cpu":
        return patches_fold_plain(acc, cells, window, core)
    check_fold(acc, cells, window, core)
    return _launch_fold(acc.contiguous(), cells, window, tuple(core))
