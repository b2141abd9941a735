"""Permutation-equivariant set network, DeepSets-style (port of
nbody_tpu/models/set_net.py; reference nn.py:10-97).

Layer: h_out = (h - mean_N(h)) @ W + B.  Mean-centring over the particle
axis makes the layer permutation-equivariant; it is the only coupling
between particles.  The products are plain torch matmuls, as they were
an XLA einsum outside any Pallas kernel in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from nbody_tpu_torch.models.base import LayerParams, init_network_params


def init_set_params(generator: torch.Generator,
                    channels: Sequence[int]) -> LayerParams:
    """Per layer: W (1, k_in, k_out), B (1, k_out)."""
    return init_network_params(generator, channels, num_weights=1,
                               num_biases=1)


def set_layer(h_in: torch.Tensor, layer_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(b, N, k) -> (b, N, q): (X - X_mu) . W + B (reference nn.py:10-28)."""
    h = h_in - torch.mean(h_in, dim=1, keepdim=True)
    return torch.matmul(h, layer_params["W"][0]) + layer_params["B"][0]


def set_network(params: List[Dict[str, torch.Tensor]], x_in: torch.Tensor,
                activation: Callable = torch.relu) -> torch.Tensor:
    """Layer stack with `activation` on every layer but the last
    (reference network_func_set, nn.py:31-67)."""
    h = x_in
    for i, layer_params in enumerate(params):
        h = set_layer(h, layer_params)
        if i < len(params) - 1:
            h = activation(h)
    return h
