"""Shift-invariant sparse graph network, 4-operator basis (port of the dense
form of nbody_tpu/models/shiftinv.py; reference graph.py:367-515).

Edge features live in a regular (b, N, K, C) array over the kNN graph:

  op 1  identity            H @ W1
  op 2  pool rows (by col)  scatter-mean by neighbor id, @ W2, gather back
  op 3  pool cols (by row)  mean over the K axis, @ W3
  op 4  pool cube           mean over (N, K), @ W4

Pooled tensors are multiplied at their pooled size before broadcasting
(identical by linearity).  The last layer pools edges back to particles
with a mean over K.  The gather and scatter are the port's CUDA kernels
(ops/banded.py); the weight products are plain torch matmuls, as they were
plain XLA dots in JAX.  The TPU block-major form and the velocity model
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from nbody_tpu_torch.models.base import LayerParams, init_network_params
from nbody_tpu_torch.ops.banded import (neighbor_counts, neighbor_gather,
                                        neighbor_segment_mean)
from nbody_tpu_torch.ops.graph_features import edge_features_za


def init_shiftinv_params(generator: torch.Generator,
                         channels: Sequence[int]) -> LayerParams:
    """Per layer: W (4, k_in, k_out), B (1, k_out) (reference utils.py:179-180)."""
    return init_network_params(generator, channels, num_weights=4, num_biases=1)


def shift_inv_layer(h: torch.Tensor, idx: torch.Tensor,
                    layer_params: Dict[str, torch.Tensor],
                    is_last: bool = False,
                    counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One 4-op layer (shiftinv.py:45-105).  h (b, N, K, C) edges, idx
    (b, N, K).  counts: in-degrees shared by every layer.  Returns
    (b, N, K, q), or (b, N, q) if is_last."""
    w = layer_params["W"]          # (4, C, q)
    bias = layer_params["B"][0]    # (q,)
    c_in, q = w.shape[1], w.shape[2]
    if q < c_in:
        # ops 1+2 share the edge-level operand: one product against
        # [W1|W2]; the scatter and gather then run at width q
        h12 = torch.matmul(h, torch.cat([w[0], w[1]], dim=1))
        h1, hw = h12[..., :q], h12[..., q:]
        pooled_rows = neighbor_segment_mean(hw, idx, counts)
        h2 = neighbor_gather(pooled_rows, idx)                  # (b, N, K, q)
    else:
        h1 = torch.matmul(h, w[0])
        pooled_rows = neighbor_segment_mean(h, idx, counts)
        h2 = torch.matmul(neighbor_gather(pooled_rows, idx), w[1])

    # op 3: pool cols == mean over K, broadcast over K
    pooled_cols = torch.mean(h, dim=2)                          # (b, N, C)
    h3 = torch.matmul(pooled_cols, w[2])[:, :, None, :]
    # op 4: cube mean == mean of the K-means (every row has K slots)
    pooled_all = torch.mean(pooled_cols, dim=1)                 # (b, C)
    h4 = torch.matmul(pooled_all, w[3])[:, None, None, :]

    h_out = h1 + h2 + h3 + h4 + bias
    if is_last:
        return torch.mean(h_out, dim=2)                         # (b, N, q)
    return h_out


def shiftinv_network(params: List[Dict[str, torch.Tensor]], edges: torch.Tensor,
                     idx: torch.Tensor,
                     activation: Callable = torch.relu) -> torch.Tensor:
    """Layer stack (reference network_func_shift_inv_za, graph.py:463-476);
    in-degree counts in the edge dtype, computed once for all layers."""
    h = edges
    counts = neighbor_counts(idx, edges.dtype)
    for i, layer_params in enumerate(params):
        is_last = i == len(params) - 1
        h = shift_inv_layer(h, idx, layer_params, is_last=is_last, counts=counts)
        if not is_last:
            h = activation(h)
    return h


def shiftinv_model(params: List[Dict[str, torch.Tensor]], pos: torch.Tensor,
                   za_disp: torch.Tensor, idx: torch.Tensor, box: float,
                   activation: Callable = torch.relu) -> torch.Tensor:
    """Featurize + network (reference model_func_shift_inv_za).  pos
    (b, N, 3) raw positions (grid + ZA), za_disp (b, N, 3), idx (b, N, K)
    with self at slot 0 -> (b, N, q)."""
    edges = edge_features_za(pos, idx, za_disp, box)
    return shiftinv_network(params, edges, idx, activation)
