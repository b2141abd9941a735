"""Kernels B and C: neighbor gather and scatter-add (wrappers of
csrc/banded_kernels.cu), and the graph plan the scatter runs over.

Replace nbody_tpu/ops/pallas/banded_kernels.py : banded_gather_pallas and
banded_scatter_add_pallas, with their exact (band=None) semantics:
  gather:  out[b, n, k, :] = values[b, idx[b, n, k], :]        (B,N,K,C)
  scatter: out[b, j, :]    = sum_{(n,k): idx[b,n,k]==j} vals[b, n, k, :]
The gather is an exact copy in the input dtype (f32 input is not rounded
to bf16, unlike the Pallas ``fast`` mode).  The scatter is a segment sum
over a ``GraphPlan`` -- the flat edge ids sorted by target, ties by
ascending edge id, and each target's offsets -- built once per forward
from idx (``graph_plan``, plain torch: index bookkeeping, not a kernel of
the TPU package; its ``sorted_segments`` also builds kernels E and G's
block plan).  It accumulates in f32, as the Pallas kernel did, in
ascending edge order, and returns the input dtype: bit-equal to its plain
version on the CPU, whose index_add_ adds in the same order.

On the H100 both are memory-bound (well under 1 FLOP/byte); the kernels
stream the (B, N, K, C) side with coalesced, vectorized accesses while the
(B, N, C) side stays in L2 (design note in the .cu file).

Each wrapper takes its plain PyTorch version only for a CPU tensor; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "neighbor_gather_rows": (_P, _P, _P, _L, _L, _L, _L, _I, _I, _P),
    "neighbor_segment_sum": (_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _P),
}
# grid limit of the one-thread-per-unit launches (2^31 - 1 blocks of 256)
_MAX_UNITS = (2 ** 31 - 1) * 256
_INT32_MAX = 2 ** 31 - 1


def library():
    """The built and loaded csrc/banded_kernels.cu (compiled at first use)."""
    return build.load("banded_kernels", _SIGNATURES)


class GraphPlan(NamedTuple):
    """The kNN graph sorted by target, shared by every scatter of a step.

    order:   (B*N*K,) int32 flat edge ids (b*N + n)*K + k, sorted by target
             b*N + idx[b, n, k], ties by ascending edge id; edges whose
             target lies outside [0, N) come last, past offsets[-1].
    offsets: (B*N + 1,) int32; target t's edges are order[offsets[t]:
             offsets[t + 1]]."""
    order: torch.Tensor
    offsets: torch.Tensor

    def in_degree(self, b: int, n: int, dtype=torch.float32) -> torch.Tensor:
        """(b, N) in-degree of every particle, in `dtype`."""
        return (self.offsets[1:] - self.offsets[:-1]).reshape(b, n).to(dtype)


@torch.no_grad()
def sorted_segments(keys: torch.Tensor, n_targets: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan of a segment sum: keys (E,) int32, the target of each flat
    edge in [0, n_targets] (n_targets: no target) -> (order, offsets), a
    stable sort of the keys (ties by ascending edge id) and a search of
    each target's first edge.  Shared by graph_plan and the block plan
    (ops/kernels/block_kernels.block_plan)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    targets = torch.arange(n_targets + 1, dtype=torch.int32, device=keys.device)
    offsets = torch.searchsorted(sorted_keys, targets, out_int32=True)
    return order.to(torch.int32), offsets


@torch.no_grad()
def graph_plan(idx: torch.Tensor) -> GraphPlan:
    """idx (B, N, K) int32 -> its GraphPlan: sorted_segments of the int32
    target keys b*N + idx."""
    b, n, k = idx.shape
    if idx.dtype != torch.int32:
        raise ValueError(f"graph_plan: idx must be int32, got {idx.dtype}")
    if b * n * k > _INT32_MAX:
        raise ValueError(f"graph_plan: {b * n * k} edges exceed int32 ids")
    base = torch.arange(b, dtype=torch.int32, device=idx.device) * n
    valid = (idx >= 0) & (idx < n)
    keys = torch.where(valid, idx + base[:, None, None], b * n).reshape(-1)
    return GraphPlan(*sorted_segments(keys, b * n))


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
    """The scatter-add straight from idx: index_add_ into an f32 (f64 for
    f64 input) accumulator, cast to the input dtype.  On the CPU it adds
    sequentially in edge order, the order of the segment sum."""
    b, n, k, c = vals.shape
    acc_dt = torch.promote_types(vals.dtype, torch.float32)
    acc = torch.zeros((b * n, c), dtype=acc_dt, device=vals.device)
    acc.index_add_(0, _flat_targets(idx, n), vals.reshape(-1, c).to(acc_dt))
    return acc.reshape(b, n, c).to(vals.dtype)


def plan_sum_plain(rows: torch.Tensor, order: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """The segment sum of a plan in plain PyTorch: rows (E, C), the plan's
    edges in plan order index_add_-ed by target into (targets, C) f32 (f64
    for f64 input) rows.  On the CPU index_add_ adds sequentially, so each
    target's sum is taken in ascending edge order, as the kernels take it."""
    acc_dt = torch.promote_types(rows.dtype, torch.float32)
    degree = (offsets[1:] - offsets[:-1]).long()
    targets = torch.repeat_interleave(
        torch.arange(degree.numel(), device=rows.device), degree)
    ids = order[:targets.numel()].long()
    acc = torch.zeros((degree.numel(), rows.shape[1]), dtype=acc_dt,
                      device=rows.device)
    return acc.index_add_(0, targets, rows.index_select(0, ids).to(acc_dt))


def segment_sum_plain(vals: torch.Tensor, plan: GraphPlan) -> torch.Tensor:
    """Plain PyTorch version of kernel C: plan_sum_plain over the plan,
    cast to the input dtype."""
    b, n, k, c = vals.shape
    acc = plan_sum_plain(vals.reshape(-1, c), plan.order, plan.offsets)
    return acc.reshape(b, n, c).to(vals.dtype)


def _check_device(x: torch.Tensor, name: str, *others: torch.Tensor):
    if any(o.device != x.device for o in others):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in (x, *others)]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")
    if x.device.type == "cuda":
        if x.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name} kernel takes float32 or bfloat16, "
                             f"got {x.dtype}")
        if not all(t.is_contiguous() for t in (x, *others)):
            raise ValueError(f"{name} kernel takes contiguous tensors")


def _check(x: torch.Tensor, idx: torch.Tensor, x_dims: int, name: str):
    if x.dim() != x_dims or idx.dim() != 3:
        raise ValueError(f"{name}: bad ranks {tuple(x.shape)}, idx {tuple(idx.shape)}")
    if x.shape[:x_dims - 1] != idx.shape[:x_dims - 1]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} and idx "
                         f"{tuple(idx.shape)} disagree")
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32, got {idx.dtype}")
    _check_device(x, name, idx)
    if x.device.type == "cuda" and (
            x.numel() > _MAX_UNITS or idx.numel() * x.shape[-1] > _MAX_UNITS):
        raise ValueError(f"{name}: too large for one launch")


def _check_plan(vals: torch.Tensor, plan: GraphPlan):
    if vals.dim() != 4:
        raise ValueError(f"neighbor_segment_sum: vals must be (B, N, K, C), "
                         f"got {tuple(vals.shape)}")
    b, n, k, _ = vals.shape
    order, offsets = plan
    if order.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("neighbor_segment_sum: the plan's tensors must be int32")
    if order.shape != (b * n * k,) or offsets.shape != (b * n + 1,):
        raise ValueError(f"neighbor_segment_sum: plan ({tuple(order.shape)}, "
                         f"{tuple(offsets.shape)}) does not fit vals "
                         f"{tuple(vals.shape)}")
    _check_device(vals, "neighbor_segment_sum", order, offsets)
    if vals.device.type == "cuda" and b * n * vals.shape[-1] > _MAX_UNITS:
        raise ValueError("neighbor_segment_sum: too large for one launch")


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
        unit, values.device.index, build.stream(values.device.index))
    build.check_launch(err, "neighbor_gather_rows")
    tracing.count("launch.neighbor_gather")
    return out


def neighbor_segment_sum(vals: torch.Tensor, plan: GraphPlan) -> torch.Tensor:
    """Kernel C: vals (B, N, K, C) summed by target over `plan` -> (B, N, C)
    in the input dtype."""
    _check_plan(vals, plan)
    if vals.device.type == "cpu":
        return segment_sum_plain(vals, plan)
    b, n, k, c = vals.shape
    out = torch.empty((b, n, c), dtype=vals.dtype, device=vals.device)
    esize = vals.element_size()
    vec = _unit_bytes(c * esize, vals.data_ptr(), out.data_ptr()) // esize
    lib = library()
    err = lib.neighbor_segment_sum(
        vals.data_ptr(), plan.order.data_ptr(), plan.offsets.data_ptr(),
        out.data_ptr(), b * n, b * n * k, c, vec,
        int(vals.dtype == torch.bfloat16), vals.device.index,
        build.stream(vals.device.index))
    build.check_launch(err, "neighbor_segment_sum")
    tracing.count("launch.neighbor_segment_sum")
    return out


def neighbor_scatter_add(vals: torch.Tensor, idx: torch.Tensor,
                         plan: Optional[GraphPlan] = None) -> torch.Tensor:
    """vals (B, N, K, C), idx (B, N, K) int32 -> (B, N, C) summed by target:
    kernel C over `plan`, built from idx when not given."""
    _check(vals, idx, 4, "neighbor_scatter_add")
    return neighbor_segment_sum(vals, plan if plan is not None else graph_plan(idx))
