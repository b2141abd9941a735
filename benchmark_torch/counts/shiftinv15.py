"""Counts of the 15-op family (models/shiftinv15.py): useful FLOPs of a
train step, and the neighbor gathers and scatters of one train step on
the direct route and on the masked index route, with their shapes.

Direct route (kernels B and C).  Forward: the symmetrized graph's id
gather (width K, f32) and degree sum (width 1, f32); the features'
gather (width 3, compute dtype); in each layer the fused pool scatter
(width 2C, f32: the f32 mask promotes it), the reverse-edge lookup
(kernel B at K' = 1 over the (b, N*K, W) edge table, W the narrower of
the layer's widths) and the column and row broadcast gathers (width q);
the last layer's row pool (width q, f32).  Layer 0 runs in the compute
dtype, the later layers in f32, as the cube form's promotions make them.
Backward: layer 0's broadcasts' scatters; in layers 1-5 the pool
scatter's gather, the lookup's scatter and the broadcasts' scatters; the
row pool's gather.  At 3-32-64-64-32-16-3: B 26, C 25.

Index route (kernels D and E over block-major edges, self slot dropped:
K - 1 edges a node; B and C only for the id gather, the degree and the
lookups; everything in the compute dtype).  Forward: the id gather and
the degree as above, the features' gather (D, width 3), in each layer the
fused scatter (E, width 2C), the fused gather (D, width 2q) and the
lookup (B, K' = 1), and the row pool (E, width q).  Backward: layer 0's
fused gather's scatter (E, 2q); in layers 1-5 the fused scatter's gather
(D, 2C), the lookup's scatter (C) and the fused gather's scatter (E,
2q); the row pool's gather (D, q).  At 3-32-64-64-32-16-3: B 7, C 6,
D 13, E 13.
"""

from __future__ import annotations

from benchmark_torch.counts.common import DTYPE_BYTES, Call, pairs, route_of
from benchmark_torch.yardstick.flops import train_step_flops

F32 = DTYPE_BYTES["float32"]


def unit_flops(cfg: dict, traffic: dict) -> float:
    """Useful FLOPs of one train step."""
    return train_step_flops(cfg["family"], cfg["cells"] ** 3, traffic["batch"],
                            cfg["k_neighbors"], cfg["channels"])


def neighbor_calls(cfg: dict, traffic: dict):
    """The gathers and scatters of one train step, or None where the
    route is not counted here."""
    route = route_of(traffic)
    if traffic["driver"] != "train_scan" or route not in ("direct", "index"):
        return None
    b, k = traffic["batch"], cfg["k_neighbors"]
    rows = b * cfg["cells"] ** 3
    edges = rows * k
    s = DTYPE_BYTES[cfg["dtype"]]
    layers = pairs(cfg["channels"])
    calls = [Call("gather", rows, edges, k, F32), Call("scatter", rows, edges, 1, F32)]
    if route == "direct":
        calls.append(Call("gather", rows, edges, 3, s))
        for i, (c, q) in enumerate(layers):
            e = s if i == 0 else F32
            w = min(c, q)
            calls += [Call("scatter", rows, edges, 2 * c, F32),
                      Call("gather", edges, edges, w, e),
                      Call("gather", rows, edges, q, e),
                      Call("gather", rows, edges, q, e)]
            calls += [Call("scatter", rows, edges, q, e)] * 2
            if i > 0:
                calls += [Call("gather", rows, edges, 2 * c, F32),
                          Call("scatter", edges, edges, w, F32)]
        q = layers[-1][1]
        calls += [Call("scatter", rows, edges, q, F32), Call("gather", rows, edges, q, F32)]
        return calls
    sparse = rows * (k - 1)
    calls.append(Call("gather", rows, sparse, 3, s))
    for i, (c, q) in enumerate(layers):
        w = min(c, q)
        calls += [Call("scatter", rows, sparse, 2 * c, s),
                  Call("gather", rows, sparse, 2 * q, s),
                  Call("gather", edges, edges, w, s),
                  Call("scatter", rows, sparse, 2 * q, s)]
        if i > 0:
            calls += [Call("gather", rows, sparse, 2 * c, s),
                      Call("scatter", edges, edges, w, s)]
    q = layers[-1][1]
    calls += [Call("scatter", rows, sparse, q, s), Call("gather", rows, sparse, q, s)]
    return calls
