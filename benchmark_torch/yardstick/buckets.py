"""Kernel-name buckets and the reduction of a profiler window to device
time, busy time, idle gaps and the top device operations.

The buckets are copied from scripts/torch_step_profile.py (``BUCKETS``,
``bucket_of``), with two additions: "nvjet" (the Hopper cuBLAS GEMMs'
names) in the matmul bucket, and kernel J's bucket; the busy and idle
arithmetic follows its
``profile_steps``, with the busy time taken as the union of the device
intervals instead of their sum, so that overlapping kernels are not
counted twice.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

BUCKETS = (
    ("A lattice_knn", ("lattice_knn_kernel",)),
    ("A topk_min", ("topk_min_kernel",)),
    ("B gather", ("gather_rows_kernel",)),
    # E/G: the segment sum's instance tagged block_sites (C's is tagged
    # graph_targets), or the shared-memory atomic form
    ("E/G scatter", ("select_scatter_kernel", "segment_sum_kernel<block_sites")),
    ("C segment sum", ("segment_sum_kernel",)),
    ("D/F gather", ("patch_gather_kernel", "select_gather_kernel")),
    ("I mask scatter", ("mask_scatter_kernel", "mask_dot_kernel<true, true,",
                        "mask_dot_kernel<true, false,")),
    ("H mask gather", ("mask_gather_kernel", "mask_dot_kernel")),
    ("J fused boundary", ("fused_boundary",)),
    ("C atomic scatter", ("scatter_add_kernel",)),
    ("sort + search", ("adix", "sort", "Sort", "searchsorted")),
    ("matmul", ("gemm", "Gemm", "cutlass", "xmma", "sm90", "cublas", "ampere",
                "nvjet")),
    ("reduction", ("reduce_kernel",)),
    ("torch index / scatter", ("index", "Index", "scatter_gather")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Elementwise")),
    ("copy / fill / cat", ("Memcpy", "Memset", "copy", "fill", "Cat")),
)
# the buckets of the repository's own kernels (csrc/*.cu)
REPO_BUCKETS = ("A lattice_knn", "A topk_min", "B gather", "E/G scatter",
                "C segment sum", "D/F gather", "I mask scatter",
                "H mask gather", "J fused boundary", "C atomic scatter")
PLAN_BUCKET = "sort + search"
GEMM_BUCKET = "matmul"


def bucket_of(name: str) -> str:
    for label, pats in BUCKETS:
        if any(p in name for p in pats):
            return label
    return "other"


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The gaps (start, end) between the merged device intervals."""
    gaps, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def seconds_by(kernels, key) -> Dict[str, float]:
    """Device seconds of (name, start, end) kernels summed by key(name)."""
    out: Dict[str, float] = {}
    for name, s, e in kernels:
        k = key(name)
        out[k] = out.get(k, 0.0) + (e - s)
    return out


def name_gaps(gaps, host_events, top: int = 10):
    """[[host operation, idle seconds], ...]: the 2,000 longest idle gaps,
    summed by the innermost host operation (name, start, end) that spans
    each gap's middle (of the 256 that started last before it; "no host
    operation" where none does), longest first."""
    events = sorted(host_events, key=lambda ev: ev[1])
    starts = [ev[1] for ev in events]
    totals: Dict[str, float] = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = 0.5 * (s + e)
        name = "no host operation"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(last - 256, -1), -1):
            if events[j][2] >= mid:
                name = events[j][0]
                break
        totals[name] = totals.get(name, 0.0) + (e - s)
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]
