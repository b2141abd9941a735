"""Kernels B and C: neighbor gather and scatter-add (wrappers of
csrc/banded_kernels.cu).

Replace nbody_tpu/ops/pallas/banded_kernels.py : banded_gather_pallas and
banded_scatter_add_pallas, with their exact (band=None) semantics:
  gather:  out[b, n, k, :] = values[b, idx[b, n, k], :]        (B,N,K,C)
  scatter: out[b, j, :]    = sum_{(n,k): idx[b,n,k]==j} vals[b, n, k, :]
The gather is an exact copy in the input dtype (f32 input is not rounded
to bf16, unlike the Pallas ``fast`` mode).  The scatter accumulates in f32
with atomic adds, as the Pallas kernel accumulated in f32, and casts the
sums to the input dtype; the order of the atomics varies from run to run
(tolerance in the .cu file's note).

On the H100 both are memory-bound (well under 1 FLOP/byte); the kernels
stream the (B, N, K, C) side with coalesced, vectorized accesses while the
(B, N, C) side stays in L2 (design note in the .cu file).

Each wrapper takes its plain PyTorch version only for a CPU tensor; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from nbody_tpu_torch.ops.kernels import build

# launches of the CUDA kernels in this process (reset by callers that count)
LAUNCHES = {"neighbor_gather": 0, "neighbor_scatter_add": 0}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "neighbor_gather_rows": (_P, _P, _P, _L, _L, _L, _L, _I, _I, _P),
    "neighbor_scatter_add_f32acc": (_P, _P, _P, _L, _L, _L, _L, _I, _I, _P),
}
# grid limit of the one-thread-per-unit launches (2^31 - 1 blocks of 256)
_MAX_UNITS = (2 ** 31 - 1) * 256


def library():
    """The built and loaded csrc/banded_kernels.cu (compiled at first use)."""
    return build.load("banded_kernels", _SIGNATURES)


def _flat_targets(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(b, N, K) per-cube ids -> (b*N*K,) int64 rows of the (b*N, C) view."""
    offs = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64) * n
    return (idx.to(torch.int64) + offs[:, None, None]).reshape(-1)


def gather_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B: index_select on int64 ids."""
    b, n, c = values.shape
    k = idx.shape[-1]
    out = values.reshape(b * n, c).index_select(0, _flat_targets(idx, n))
    return out.reshape(b, n, k, c)


def scatter_add_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C: index_add_ into an f32 (f64 for
    f64 input) accumulator, cast to the input dtype."""
    b, n, k, c = vals.shape
    acc_dt = torch.promote_types(vals.dtype, torch.float32)
    acc = torch.zeros((b * n, c), dtype=acc_dt, device=vals.device)
    acc.index_add_(0, _flat_targets(idx, n), vals.reshape(-1, c).to(acc_dt))
    return acc.reshape(b, n, c).to(vals.dtype)


def _check(x: torch.Tensor, idx: torch.Tensor, x_dims: int, name: str):
    if x.dim() != x_dims or idx.dim() != 3:
        raise ValueError(f"{name}: bad ranks {tuple(x.shape)}, idx {tuple(idx.shape)}")
    if x.shape[:x_dims - 1] != idx.shape[:x_dims - 1]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} and idx "
                         f"{tuple(idx.shape)} disagree")
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32, got {idx.dtype}")
    if x.device != idx.device:
        raise ValueError(f"{name}: tensors on {x.device} and {idx.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")
    if x.device.type == "cuda":
        if x.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name} kernel takes float32 or bfloat16, "
                             f"got {x.dtype}")
        if not (x.is_contiguous() and idx.is_contiguous()):
            raise ValueError(f"{name} kernel takes contiguous tensors")
        if x.numel() > _MAX_UNITS or idx.numel() * x.shape[-1] > _MAX_UNITS:
            raise ValueError(f"{name}: too large for one launch")


def _unit_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest copy unit dividing the row length and both buffers' alignment."""
    for u in (16, 8, 4, 2):
        if row_bytes % u == 0 and all(p % u == 0 for p in ptrs):
            return u
    raise ValueError(f"rows of {row_bytes} bytes cannot be copied in 2-byte units")


def neighbor_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, N, C), idx (B, N, K) int32 -> (B, N, K, C) = values[idx]."""
    _check(values, idx, 3, "neighbor_gather")
    if values.device.type == "cpu":
        return gather_plain(values, idx)
    b, n, c = values.shape
    k = idx.shape[-1]
    out = torch.empty((b, n, k, c), dtype=values.dtype, device=values.device)
    row_bytes = c * values.element_size()
    unit = _unit_bytes(row_bytes, values.data_ptr(), out.data_ptr())
    lib = library()
    err = lib.neighbor_gather_rows(
        values.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, k, row_bytes,
        unit, values.device.index,
        torch.cuda.current_stream(values.device).cuda_stream)
    build.check_launch(err, "neighbor_gather_rows")
    LAUNCHES["neighbor_gather"] += 1
    return out


def neighbor_scatter_add(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals (B, N, K, C), idx (B, N, K) int32 -> (B, N, C) summed by target."""
    _check(vals, idx, 4, "neighbor_scatter_add")
    if vals.device.type == "cpu":
        return scatter_add_plain(vals, idx)
    b, n, k, c = vals.shape
    acc = torch.zeros((b, n, c), dtype=torch.float32, device=vals.device)
    lib = library()
    err = lib.neighbor_scatter_add_f32acc(
        vals.data_ptr(), idx.data_ptr(), acc.data_ptr(), b, n, k, c,
        int(vals.dtype == torch.bfloat16), vals.device.index,
        torch.cuda.current_stream(vals.device).cuda_stream)
    build.check_launch(err, "neighbor_scatter_add_f32acc")
    LAUNCHES["neighbor_scatter_add"] += 1
    return acc if vals.dtype == torch.float32 else acc.to(vals.dtype)
