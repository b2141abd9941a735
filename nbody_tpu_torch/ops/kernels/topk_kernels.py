"""Kernel A: the lattice kNN (wrappers of csrc/topk_kernels.cu).

Replaces nbody_tpu/ops/pallas/topk_kernels.py : topk_min_pallas and the
distance computation in front of it (nbody_tpu/ops/knn.py:173-239).  Two
kernels share one selection:
  topk_min:    (rows, M) f32 distances -> (rows, k) int32 slots of the k
               smallest, ascending, ties to the lowest slot, NaN > +inf >
               finite: jax.lax.top_k(-d2, k) order;
  lattice_knn: grid-ordered positions (b, cells^3, 3) f32 -> (b, cells^3,
               k) int32 neighbor ids, the candidates' distances computed
               in-kernel, so that the (rows, M) array never reaches device
               memory.  The main path's graph build.
Their plain versions are the unfused composition: ``lattice_sq_dist`` (the
(2w+1)^3 rolls of the position cube, scored with the same expression tree
as the JAX package so that near-ties break the same way), ``topk_min_plain``
(a stable sort) and the arithmetic slot decode with per-axis wrap.

On the H100 topk_min is memory-bound (M*4 bytes in, k*4 out per row) and
lattice_knn bound by its FP32 issue (~20 operations per candidate); the
.cu file has the design notes.  Each wrapper takes its plain PyTorch
version only for a CPU tensor; for a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import build
from nbody_tpu_torch.physics.pbc import min_image_diff

KMAX = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "topk_min_f32": (_P, _P, ctypes.c_longlong, _I, _I, _I, _P),
    "topk_max_m": (),
    "lattice_knn_f32": (_P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P),
    "lattice_knn_smem_bytes": (_I, _I),
    "lattice_knn_max_smem": (_I,),
}


def library():
    """The built and loaded csrc/topk_kernels.cu (compiled at first use)."""
    return build.load("topk_kernels", _SIGNATURES)


def lattice_window(cells: int, window: int):
    """Clamped half-width w and the lexicographic (dx, dy, dz) roll list."""
    w = min(window, (cells - 1) // 2)
    offs = [(dx, dy, dz)
            for dx in range(-w, w + 1)
            for dy in range(-w, w + 1)
            for dz in range(-w, w + 1)]
    return w, offs


def topk_min_plain(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: a stable ascending sort of the clamp-encoded
    distances (the encoding of topk_kernels.py:34-35), first k slots.
    A stable sort keeps equal values in slot order -- the lowest-slot tie
    rule -- which torch.topk does not promise."""
    big = torch.finfo(d2.dtype).max
    enc = torch.where(torch.isnan(d2), big * 0.5, torch.clamp_max(d2, big * 0.25))
    return torch.sort(enc, dim=-1, stable=True).indices[..., :k].to(torch.int32)


def topk_min(d2: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, M) f32 -> (rows, k) int32 slots, ascending, lowest-slot ties."""
    if d2.dim() != 2:
        raise ValueError(f"d2 must be (rows, M), got shape {tuple(d2.shape)}")
    rows, m = d2.shape
    if not 1 <= k <= min(m, KMAX):
        raise ValueError(f"need 1 <= k <= min(M, {KMAX}); k={k}, M={m}")
    if d2.device.type == "cpu":
        return topk_min_plain(d2, k)
    if d2.device.type != "cuda":
        raise ValueError(f"topk_min runs on cpu or cuda tensors, not {d2.device}")
    if d2.dtype != torch.float32 or not d2.is_contiguous():
        raise ValueError("topk_min kernel takes a contiguous float32 tensor")
    lib = library()
    if m > lib.topk_max_m():
        raise ValueError(f"M={m} exceeds the kernel's {lib.topk_max_m()} "
                         "candidates per row")
    out = torch.empty((rows, k), dtype=torch.int32, device=d2.device)
    err = lib.topk_min_f32(d2.data_ptr(), out.data_ptr(), rows, m, k,
                           d2.device.index, build.stream(d2.device.index))
    build.check_launch(err, "topk_min_f32")
    tracing.count("launch.topk_min")
    return out


@torch.no_grad()
def lattice_sq_dist(pos: torch.Tensor, cells: int, box: float = 1.0,
                    window: int = 3) -> torch.Tensor:
    """Squared min-image distances to the (2w+1)^3 lattice candidates:
    pos (b, N, 3) grid-ordered -> d2 (b, N, M), the self slot set to -1."""
    b, n, _ = pos.shape
    if cells ** 3 != n:
        raise ValueError(f"pos must be a cells^3 cube in grid order "
                         f"(cells={cells}, N={n})")
    _, offs = lattice_window(cells, window)
    grid = pos.reshape(b, cells, cells, cells, 3)
    cands = torch.stack(
        [torch.roll(grid, (-dx, -dy, -dz), dims=(1, 2, 3)).reshape(b, n, 3)
         for (dx, dy, dz) in offs], dim=2)           # (b, N, M, 3)
    delta = min_image_diff(cands, pos[:, :, None, :], box)
    sq = delta * delta
    # XLA's left-to-right xyz sum, written out so that no backend's
    # reduction may reassociate it (near-ties must break the same way)
    d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]         # (b, N, M)
    d2[:, :, offs.index((0, 0, 0))] = -1.0
    return d2


def decode_slots(sel: torch.Tensor, cells: int, w: int) -> torch.Tensor:
    """(b, N, k) lexicographic offset slots -> (b, N, k) int32 neighbor ids,
    wrapped per axis (nbody_tpu/ops/knn.py:226-239)."""
    m = 2 * w + 1
    sel = sel.long()
    ii = torch.arange(cells ** 3, device=sel.device)
    x = (ii // (cells * cells))[:, None]
    y = ((ii // cells) % cells)[:, None]
    z = (ii % cells)[:, None]
    nx = torch.remainder(x + sel // (m * m) - w, cells)
    ny = torch.remainder(y + (sel // m) % m - w, cells)
    nz = torch.remainder(z + sel % m - w, cells)
    return ((nx * cells + ny) * cells + nz).to(torch.int32)


@torch.no_grad()
def lattice_knn_plain(pos: torch.Tensor, k: int, cells: int, window: int = 3,
                      box: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of lattice_knn: lattice_sq_dist, then
    topk_min_plain, then decode_slots."""
    b, n, _ = pos.shape
    d2 = lattice_sq_dist(pos, cells, box, window)
    w, _ = lattice_window(cells, window)
    sel = topk_min_plain(d2.reshape(b * n, d2.shape[-1]), k).reshape(b, n, k)
    return decode_slots(sel, cells, w)


@torch.no_grad()
def lattice_knn(pos: torch.Tensor, k: int, cells: int, window: int = 3,
                box: float = 1.0) -> torch.Tensor:
    """Cell-list kNN of grid-ordered cubes: pos (b, cells^3, 3) f32 ->
    (b, cells^3, k) int32 ids, self at slot 0."""
    if pos.dim() != 3 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be (b, N, 3), got {tuple(pos.shape)}")
    b, n, _ = pos.shape
    if cells ** 3 != n:
        raise ValueError(f"pos must be a cells^3 cube in grid order "
                         f"(cells={cells}, N={n})")
    w, offs = lattice_window(cells, window)
    if not 1 <= k <= min(len(offs), KMAX):
        raise ValueError(f"need 1 <= k <= min((2w+1)^3, {KMAX}); k={k}, "
                         f"(2w+1)^3={len(offs)}")
    if pos.device.type == "cpu":
        return lattice_knn_plain(pos, k, cells, window, box)
    if pos.device.type != "cuda":
        raise ValueError(f"lattice_knn runs on cpu or cuda tensors, not {pos.device}")
    if pos.dtype != torch.float32 or not pos.is_contiguous():
        raise ValueError("lattice_knn kernel takes a contiguous float32 tensor")
    lib = library()
    dev = pos.device.index
    if lib.lattice_knn_smem_bytes(w, k) > lib.lattice_knn_max_smem(dev):
        raise ValueError(f"lattice_knn: window {w} needs more shared memory "
                         "than a block may use")
    out = torch.empty((b, n, k), dtype=torch.int32, device=pos.device)
    err = lib.lattice_knn_f32(pos.data_ptr(), out.data_ptr(), b, cells, w, k,
                              box, dev, build.stream(dev))
    build.check_launch(err, "lattice_knn_f32")
    tracing.count("launch.lattice_knn")
    return out
