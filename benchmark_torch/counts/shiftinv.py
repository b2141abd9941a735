"""Counts of the 4-op family (models/shiftinv.py): useful FLOPs of a train
step or a hop, and the neighbor gathers and scatters of one train step on
the direct route, with their shapes.

A train step on the direct route (kernel B gathers, kernel C segment
sums; every value in the compute dtype): forward, the features' gather
(width 3) and in each layer one segment mean and one gather at the
layer's narrower width (the output width where q < C, the products
taken first, else the input width); backward, the other op at the same
width in every layer whose pooled operand needs a gradient (every layer
but a first one with q >= C).  At 3-32-64-64-32-16-3: B 12, C 11.
"""

from __future__ import annotations

from benchmark_torch.counts.common import DTYPE_BYTES, Call, pairs, route_of
from benchmark_torch.yardstick.flops import forward_flops, train_step_flops


def unit_flops(cfg: dict, traffic: dict) -> float:
    """Useful FLOPs of one unit of the traffic: a train step, or a hop."""
    n = cfg["cells"] ** 3
    args = (cfg["family"], n, traffic["batch"], cfg["k_neighbors"],
            cfg["channels"])
    if traffic["driver"] == "rollout":
        return forward_flops(*args)
    return train_step_flops(*args)


def neighbor_calls(cfg: dict, traffic: dict):
    """The gathers and scatters of one train step, or None where the
    route is not counted here."""
    if traffic["driver"] != "train_scan" or route_of(traffic) != "direct":
        return None
    b, k = traffic["batch"], cfg["k_neighbors"]
    rows = b * cfg["cells"] ** 3
    edges = rows * k
    s = DTYPE_BYTES[cfg["dtype"]]
    calls = [Call("gather", rows, edges, 3, s)]
    for i, (c, q) in enumerate(pairs(cfg["channels"])):
        w = q if q < c else c
        calls += [Call("scatter", rows, edges, w, s), Call("gather", rows, edges, w, s)]
        if i > 0 or q < c:
            calls += [Call("gather", rows, edges, w, s), Call("scatter", rows, edges, w, s)]
    return calls
