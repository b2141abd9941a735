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
(ops/banded.py picks the route from ``lattice`` / ``masks``); the weight
products are plain torch matmuls, as they were plain XLA dots in JAX.

On the masked routes (``masks`` = the BlockPlan of per-edge patch
positions, or int8 / packed int4 one-hot masks) the network keeps edge activations BLOCK-MAJOR
(b, NB, R, K, C) between layers, as _shiftinv_network_blocks does in JAX:
edges enter and leave the cube layout once.  The velocity model (shiftinv_vel) adds node velocities
to the edge features and two learnable output scalars.  With ``remat``
each layer is recomputed in the backward pass (base.remat_layer), in both
network forms, as jax.checkpoint wraps each layer in JAX.  Into an open
step timeline (tracing.py) the model marks ``plan`` and ``features`` and
probes each layer's output, outside the remat wrapper.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.models.base import (LayerParams, ShiftInvVelParams,
                                         init_network_params, remat_layer)
from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.banded import (neighbor_counts, neighbor_gather,
                                        neighbor_segment_mean, route_plan)
from nbody_tpu_torch.ops.graph_features import (edge_features_with_nodes,
                                                edge_features_za)


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


def shift_inv_layer(h: torch.Tensor, idx: torch.Tensor,
                    layer_params: Dict[str, torch.Tensor],
                    is_last: bool = False,
                    counts: Optional[torch.Tensor] = None,
                    lattice=None, masks=None, plan=None) -> torch.Tensor:
    """One 4-op layer (shiftinv.py:45-105).  h (b, N, K, C) edges, idx
    (b, N, K).  counts: in-degrees shared by every layer; plan: the
    direct route's GraphPlan or the block route's BlockPlan, likewise
    shared.  Returns (b, N, K, q), or (b, N, q) if is_last."""
    w = layer_params["W"]          # (4, C, q)
    bias = layer_params["B"][0]    # (q,)
    c_in, q = w.shape[1], w.shape[2]
    if q < c_in:
        # ops 1+2 share the edge-level operand: one product against
        # [W1|W2]; the scatter and gather then run at width q
        h12 = torch.matmul(h, torch.cat([w[0], w[1]], dim=1))
        h1, hw = h12[..., :q], h12[..., q:]
        pooled_rows = neighbor_segment_mean(hw, idx, counts, lattice, masks,
                                            plan)
        h2 = neighbor_gather(pooled_rows, idx, lattice, masks, plan)  # (b, N, K, q)
    else:
        h1 = torch.matmul(h, w[0])
        pooled_rows = neighbor_segment_mean(h, idx, counts, lattice, masks,
                                            plan)
        h2 = torch.matmul(neighbor_gather(pooled_rows, idx, lattice, masks,
                                          plan), w[1])

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
                     idx: torch.Tensor, activation: Callable = torch.relu,
                     lattice=None, masks=None, plan=None,
                     remat: bool = False) -> torch.Tensor:
    """Layer stack (reference network_func_shift_inv_za, graph.py:463-476).
    The step's plan (ops/banded.route_plan, built here when not given) serves
    every layer's scatters and, on the block route, gathers, forward and
    backward; the in-degree counts, in the edge dtype, are read off it,
    once for all layers."""
    h = edges
    if plan is None:
        plan = route_plan(idx, lattice, masks)
    counts = neighbor_counts(idx, edges.dtype, lattice, masks, plan)
    layer = remat_layer(shift_inv_layer, remat)
    for i, layer_params in enumerate(params):
        is_last = i == len(params) - 1
        h = layer(h, idx, layer_params, is_last=is_last, counts=counts,
                  lattice=lattice, masks=masks, plan=plan)
        if not is_last:
            h = activation(h)
        h = tracing.probe(h, f"layer{i}")
    return h


def _shift_inv_layer_blocks(hB: torch.Tensor, layer_params, masks, cells: int,
                            window: int, counts: torch.Tensor, is_last: bool,
                            core, self_free: bool) -> torch.Tensor:
    """The 4-op layer on BLOCK-MAJOR edges hB (b, NB, R, K, C) over the
    masked routes (shiftinv.py:133-181); same semantics as
    shift_inv_layer, without the edge tensor's cube transposes."""
    w = layer_params["W"]
    bias = layer_params["B"][0]
    c_in, q = w.shape[1], w.shape[2]

    def seg_mean(e):
        s = blocked.masked_scatter_add_blocks(e, masks, cells, window,
                                              core=core, self_slot0=self_free)
        return s / torch.clamp_min(counts, 1.0)[..., None]

    if q < c_in:
        h12 = torch.matmul(hB, torch.cat([w[0], w[1]], dim=1))
        h1, hw = h12[..., :q], h12[..., q:]
        h2 = blocked.masked_gather_blocks(seg_mean(hw), masks, cells, window,
                                          core=core, self_slot0=self_free)
    else:
        h1 = torch.matmul(hB, w[0])
        pooled = blocked.masked_gather_blocks(seg_mean(hB), masks, cells,
                                              window, core=core,
                                              self_slot0=self_free)
        h2 = torch.matmul(pooled, w[1])

    pooled_cols = torch.mean(hB, dim=3)                         # (b, NB, R, C)
    h3 = torch.matmul(pooled_cols, w[2])[:, :, :, None, :]
    pooled_all = torch.mean(pooled_cols, dim=(1, 2))            # (b, C)
    h4 = torch.matmul(pooled_all, w[3])[:, None, None, None, :]

    h_out = h1 + h2 + h3 + h4 + bias
    if is_last:
        return torch.mean(h_out, dim=3)                         # (b, NB, R, q)
    return h_out


def _shiftinv_network_blocks(params, edges: torch.Tensor, masks, lattice,
                             activation: Callable,
                             remat: bool = False) -> torch.Tensor:
    """Masked-route network (shiftinv.py:184-212): edges enter and leave
    the cube layout exactly once."""
    cells, window = lattice[0], lattice[1]
    core = blocked.lattice_core(lattice)
    self_free = blocked.lattice_self_free(lattice)
    hB = blocked.edges_cube_to_blocks(edges, cells, core=core)
    counts = blocked.masked_counts(masks, cells, window, core, self_free,
                                   edges.dtype)
    layer = remat_layer(_shift_inv_layer_blocks, remat)
    for i, layer_params in enumerate(params):
        is_last = i == len(params) - 1
        hB = layer(hB, layer_params, masks, cells, window, counts, is_last,
                   core, self_free)
        if not is_last:
            hB = activation(hB)
        hB = tracing.probe(hB, f"layer{i}")
    return blocked.nodes_blocks_to_cube(hB, cells, core=core)   # (b, N, q)


def _network(params, edges, idx, activation, lattice, masks, plan, remat):
    if masks is not None and lattice is not None:
        return _shiftinv_network_blocks(params, edges, masks, lattice,
                                        activation, remat)
    return shiftinv_network(params, edges, idx, activation, lattice, masks,
                            plan, remat)


def shiftinv_model(params: List[Dict[str, torch.Tensor]], pos: torch.Tensor,
                   za_disp: torch.Tensor, idx: torch.Tensor, box: float,
                   activation: Callable = torch.relu,
                   lattice=None, masks=None, remat: bool = False) -> torch.Tensor:
    """Featurize + network (reference model_func_shift_inv_za).  pos
    (b, N, 3) raw positions (grid + ZA), za_disp (b, N, 3), idx (b, N, K)
    with self at slot 0 -> (b, N, q).  The step's plan is built once and
    serves the features' gather and the network."""
    plan = route_plan(idx, lattice, masks)
    tracing.mark("plan")
    edges = edge_features_za(pos, idx, za_disp, box, lattice, masks, plan)
    tracing.mark("features")
    return _network(params, edges, idx, activation, lattice, masks, plan,
                    remat)


def shiftinv_vel_model(params, pos: torch.Tensor, za_disp: torch.Tensor,
                       vel: torch.Tensor, idx: torch.Tensor, box: float,
                       activation: Callable = torch.relu,
                       lattice=None, masks=None,
                       remat: bool = False) -> torch.Tensor:
    """Velocity-aware model (shiftinv.py:247-274).  params {"layers": [...],
    "T": (2,)}.  Edge features [rel pos with ZA on the self-edge (3), vel
    at row (3), vel at col (3)]; output (b, N, 6): displacement and
    velocity residuals scaled by T[0] and T[1]."""
    plan = route_plan(idx, lattice, masks)
    tracing.mark("plan")
    edges = edge_features_with_nodes(pos, idx, vel, box, za_disp=za_disp,
                                     lattice=lattice, masks=masks, plan=plan)
    tracing.mark("features")
    net = _network(params["layers"], edges, idx, activation, lattice, masks,
                   plan, remat)
    t = params["T"]
    scale = torch.cat([t[0].expand(3), t[1].expand(net.shape[-1] - 3)])
    return net * scale
