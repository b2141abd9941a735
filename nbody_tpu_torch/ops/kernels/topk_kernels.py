"""Kernel A: the lattice kNN's k-smallest selection (wrapper of
csrc/topk_kernels.cu).

Replaces nbody_tpu/ops/pallas/topk_kernels.py : topk_min_pallas.  (rows, M)
f32 distances -> (rows, k) int32 slots of the k smallest, ascending, ties
to the lowest slot, NaN > +inf > finite: jax.lax.top_k(-d2, k) order.

On the H100 the selection is memory-bound (M*4 bytes in, k*4 out per row,
a few compares per byte); the kernel stages row tiles in shared memory
with coalesced loads and keeps a sorted k-list per row in registers (the
.cu file has the design note).

``topk_min`` takes the plain PyTorch version only for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from nbody_tpu_torch.ops.kernels import build

# launches of the CUDA kernel in this process (reset by callers that count)
LAUNCHES = {"topk_min": 0}
KMAX = 32

_SIGNATURES = {
    "topk_min_f32": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p),
    "topk_max_m": (),
}


def library():
    """The built and loaded csrc/topk_kernels.cu (compiled at first use)."""
    return build.load("topk_kernels", _SIGNATURES)


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
                           d2.device.index,
                           torch.cuda.current_stream(d2.device).cuda_stream)
    build.check_launch(err, "topk_min_f32")
    LAUNCHES["topk_min"] += 1
    return out
