"""Seeded weights of a graph network, made on the device.

One draw from a ``torch.Generator`` on the run's device gives every
weight of every layer (and, for the rollout, of every hop) in one call:
glorot-normal weights over each W's trailing (fan_in, fan_out) axes and
biases of 1e-8, the reference's init (utils.py:179-180, 370-379), in the
float32 the parameters are kept in.  Both the program and the plain
reference get these tensors; neither makes its own.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

BIAS_INIT = 1e-8


def make_layers(channels: Sequence[int], num_weights: int, num_biases: int,
                seed: int, device, copies: int = 1,
                last_scale: float = 1.0) -> List[Dict[str, torch.Tensor]]:
    """[{"W": (copies, num_weights, c, q), "B": (copies, num_biases, q)},
    ...] per layer, float32 on `device`; the last layer's W is scaled by
    `last_scale`."""
    pairs = list(zip(channels[:-1], channels[1:]))
    sizes = [copies * num_weights * c * q for c, q in pairs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    layers = []
    for i, ((c, q), part) in enumerate(zip(pairs, torch.split(flat, sizes))):
        std = math.sqrt(2.0 / (c + q)) * (last_scale if i == len(pairs) - 1 else 1.0)
        layers.append({
            "W": (part * std).reshape(copies, num_weights, c, q),
            "B": torch.full((copies, num_biases, q), BIAS_INIT,
                            dtype=torch.float32, device=device)})
    return layers
