"""Useful FLOPs of the graph families: the numerator of ``step_mfu`` and
``hop_mfu``.

Rewritten without JAX from nbody_tpu/utils/flops.py
(``useful_flops_forward``, ``useful_flops_train_step``), with the same
count: the weight matmuls and the node and global pools' products, every
neighbor gather and scatter counted as free data movement, and a train
step as three forward passes.  It counts the same work whatever
implements the step.  The peak is the H100's bf16 dense tensor-core rate
(yardstick/peaks.py), not the TPU v5e's of the original.
"""

from __future__ import annotations

from typing import Sequence


def _pairs(channels: Sequence[int]):
    return list(zip(channels[:-1], channels[1:]))


def forward_flops(family: str, n: int, batch: int, k: int,
                  channels: Sequence[int]) -> float:
    """Forward-pass useful FLOPs (a multiply-accumulate is 2 FLOPs)."""
    b = batch
    total = 0.0
    if family == "shiftinv":
        # per layer: two edge-level matmuls (ops 1-2), one node-pool
        # matmul (op 3), one global matmul (op 4)
        for c, q in _pairs(channels):
            total += 2.0 * b * n * k * c * q * 2
            total += 2.0 * b * n * c * q
            total += 2.0 * b * c * q
    elif family == "shiftinv15":
        # per layer: ops 1-2 at edge level on the two-block symmetrized
        # edge set (2NK slots), nine node-level ops, four global ones
        for c, q in _pairs(channels):
            total += 2.0 * b * (2 * n * k) * c * q * 2
            total += 2.0 * b * n * c * q * 9
            total += 2.0 * b * c * q * 4
    else:
        raise ValueError(f"no FLOP count for family {family!r}")
    return total


def train_step_flops(family: str, n: int, batch: int, k: int,
                     channels: Sequence[int]) -> float:
    """Forward + backward (about twice the forward for matmul chains); the
    optimizer update is not counted."""
    return 3.0 * forward_flops(family, n, batch, k, channels)
