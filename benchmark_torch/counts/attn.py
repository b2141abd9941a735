"""Counts of the attn family (models/attn.py): the useful FLOPs of a train
step, and no neighbor gathers or scatters (the family has no graph).

Counted from the layer's own shapes, a multiply-accumulate 2 FLOPs, for
b x N rows a step: in every layer (c in, q out) the three mean-centred
products xf, xg, xh (3 x 2bN c q), the (q, q) gram xf^T xg (2bN q^2,
whether it is summed over the batch or per sample) and the product of xh
with the gate (2bN q^2); in every hidden layer the residual tanh(x_in R)
(2bN 6 q), which the reference recomputes in every hidden layer and of
which the last is used.  The means, softmax, leaky relu, batch norm and
tanh are elementwise and not counted.  A train step is three forward
passes, as yardstick/flops.py counts the graph families.

Where this departs from nbody_tpu/utils/flops.py: its attn term counts
two products a layer (2 x 2bN c q) and a K-neighbor gate (2bN K q); the
layer has no neighbors, three products, the gram and the gate's product,
and the residual.  At ATTN_CHANNELS (6, 22 x 16, 3), 32^3 b10: 59,908
FLOPs a row, 19.63 GFLOP a forward, 58.89 a step.
"""

from __future__ import annotations

from typing import Sequence


def forward_flops(n: int, batch: int, channels: Sequence[int]) -> float:
    """Useful FLOPs of one forward over `batch` cubes of `n` particles."""
    rows = batch * n
    pairs = list(zip(channels[:-1], channels[1:]))
    total = 0.0
    for i, (c, q) in enumerate(pairs):
        total += 2.0 * rows * (3 * c * q + 2 * q * q)
        if i < len(pairs) - 1:
            total += 2.0 * rows * channels[0] * q
    return total


def unit_flops(cfg: dict, traffic: dict) -> float:
    """Useful FLOPs of one train step."""
    return 3.0 * forward_flops(cfg["cells"] ** 3, traffic["batch"], cfg["channels"])


def neighbor_calls(cfg: dict, traffic: dict):
    """None: the family has no neighbor gathers or scatters."""
    return None
