"""Shift-invariant sparse graph network, 4-operator basis (port of
nbody_tpu/models/shiftinv.py; reference graph.py:367-515).

Edge features live in a regular (b, N, K, C) array over the kNN graph:

  op 1  identity            H @ W1
  op 2  pool rows (by col)  scatter-mean by neighbor id, @ W2, gather back
  op 3  pool cols (by row)  mean over the K axis, @ W3
  op 4  pool cube           mean over (N, K), @ W4

Pooled tensors are multiplied at their pooled size before broadcasting
(identical by linearity).  The last layer pools edges back to particles
with a mean over K.  The gather and scatter are the port's CUDA kernels
on the step's route (ops/route.py); the weight products are plain torch
matmuls, as they were plain XLA dots in JAX.  The sum of the four terms
and the bias, and relu where the activation is relu and the layer not
the last, is one pass each way (ops/kernels/epilogue4), as XLA fused it.

One layer body serves both layouts: on the masked routes the route keeps
edge activations BLOCK-MAJOR (b, NB, R, K, C) between layers, as JAX's
block-major network does (edges enter and leave the cube layout once),
on the others in cube order (b, N, K, C); node values are in cube order
on both.  The velocity model (shiftinv_vel) adds node
velocities to the edge features and two learnable output scalars.  With
``remat`` each layer is recomputed in the backward pass
(base.remat_layer), as jax.checkpoint wraps each layer in JAX.  Into an
open step timeline (tracing.py) the model marks ``plan`` and ``features``
and probes each layer's output, outside the remat wrapper.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.models.base import (LayerParams, ShiftInvVelParams,
                                         init_network_params, remat_layer)
from nbody_tpu_torch.ops.graph_features import (edge_features_with_nodes,
                                                edge_features_za)
from nbody_tpu_torch.ops.kernels.epilogue4 import epilogue4
from nbody_tpu_torch.ops.route import Route


def init_shiftinv_params(generator: torch.Generator,
                         channels: Sequence[int]) -> LayerParams:
    """Per layer: W (4, k_in, k_out), B (1, k_out) (reference utils.py:179-180)."""
    return init_network_params(generator, channels, num_weights=4, num_biases=1)


def init_shiftinv_vel_params(generator: torch.Generator,
                             channels: Sequence[int]) -> ShiftInvVelParams:
    """4-op layers + the two output scalars T (loc, vel), init 0.002
    (shiftinv.py:235-244)."""
    layers = init_shiftinv_params(generator, channels)
    return ShiftInvVelParams(layers.layers(),
                             torch.full((2,), C.SCALAR_INIT))


def shift_inv_layer(h: torch.Tensor, route: Route,
                    layer_params: Dict[str, torch.Tensor],
                    counts: torch.Tensor, is_last: bool = False,
                    relu: bool = False) -> torch.Tensor:
    """One 4-op layer (shiftinv.py:45-105 and, block-major, :133-181) in
    the route's network layout: h (b, ..., K, C) edges, (b, N, K, C) on
    the cube routes and (b, NB, R, K, C) on the masked ones.  counts: the
    in-degrees every layer shares.  The sum of the four terms and the
    bias, with relu where `relu`, is one pass (ops/kernels/epilogue4: one
    kernel each way on a card).  Returns (b, ..., K, q), or (b, ..., q)
    if is_last."""
    w = layer_params["W"]          # (4, C, q)
    bias = layer_params["B"][0]    # (q,)
    c_in, q = w.shape[1], w.shape[2]
    if q < c_in:
        # ops 1+2 share the edge-level operand: one product against
        # [W1|W2]; the scatter and gather then run at width q
        h12 = torch.matmul(h, torch.cat([w[0], w[1]], dim=1))
        h1, hw = h12[..., :q], h12[..., q:]
        h2 = route.gather_edges(route.segment_mean(hw, counts))  # (b, ..., K, q)
    else:
        h1 = torch.matmul(h, w[0])
        h2 = torch.matmul(route.gather_edges(route.segment_mean(h, counts)),
                          w[1])

    # op 3: pool cols == mean over K, broadcast over K
    pooled_cols = torch.mean(h, dim=-2)                         # (b, ..., C)
    h3 = torch.matmul(pooled_cols, w[2])                        # (b, ..., q)
    # op 4: cube mean == mean of the K-means (every row has K slots) over
    # the node axes, N or (NB, R)
    nodes = tuple(range(1, pooled_cols.dim() - 1))
    pooled_all = torch.mean(pooled_cols, dim=nodes)             # (b, C)
    h4 = torch.matmul(pooled_all, w[3])                         # (b, q)

    h_out = epilogue4(h1, h2, h3, h4, bias, relu)
    if is_last:
        return torch.mean(h_out, dim=-2)                        # (b, ..., q)
    return h_out


def shiftinv_network(params: List[Dict[str, torch.Tensor]], edges: torch.Tensor,
                     route: Route, activation: Callable = torch.relu,
                     remat: bool = False) -> torch.Tensor:
    """Layer stack (reference network_func_shift_inv_za, graph.py:463-476;
    shiftinv.py:184-212 block-major): cube edges enter the route's network
    layout and leave it as cube nodes (b, N, q) exactly once.  The route's
    plan serves every layer's scatters and gathers, forward and backward;
    the in-degree counts, in the edge dtype, are taken once for all
    layers."""
    h = route.edges_in(edges)
    counts = route.counts(edges.dtype)
    layer = remat_layer(shift_inv_layer, remat)
    for i, layer_params in enumerate(params):
        is_last = i == len(params) - 1
        relu = activation is torch.relu and not is_last
        h = layer(h, route, layer_params, counts, is_last, relu)
        if not is_last and not relu:
            h = activation(h)
        h = tracing.probe(h, f"layer{i}")
    return route.nodes_out(h)


def shiftinv_model(params: List[Dict[str, torch.Tensor]], pos: torch.Tensor,
                   za_disp: torch.Tensor, route: Route, box: float,
                   activation: Callable = torch.relu,
                   remat: bool = False) -> torch.Tensor:
    """Featurize + network (reference model_func_shift_inv_za).  pos
    (b, N, 3) raw positions, za_disp (b, N, 3), the route of idx (b, N, K)
    with self at slot 0 (its plan built before) -> (b, N, q)."""
    tracing.mark("plan")
    edges = edge_features_za(pos, route, za_disp, box)
    tracing.mark("features")
    return shiftinv_network(params, edges, route, activation, remat)


def shiftinv_vel_model(params, pos: torch.Tensor, za_disp: torch.Tensor,
                       vel: torch.Tensor, route: Route, box: float,
                       activation: Callable = torch.relu,
                       remat: bool = False) -> torch.Tensor:
    """Velocity-aware model (shiftinv.py:247-274).  params {"layers": [...],
    "T": (2,)}.  Edge features [rel pos with ZA on the self-edge (3), vel
    at row (3), vel at col (3)]; output (b, N, 6): displacement and
    velocity residuals scaled by T[0] and T[1]."""
    tracing.mark("plan")
    edges = edge_features_with_nodes(pos, route, vel, box, za_disp=za_disp)
    tracing.mark("features")
    net = shiftinv_network(params["layers"], edges, route, activation, remat)
    t = params["T"]
    scale = torch.cat([t[0].expand(3), t[1].expand(net.shape[-1] - 3)])
    return net * scale
