"""Plain float32 reference of the velocity-aware 4-op shift-invariant graph
network, trained on the joint position+velocity loss (reference
graph.py:517-567, its commented ``_model_func_shift_inv``, with the
node-feature edges of ``include_node_features``, graph.py:245-275;
BASELINE.json config 4).

Edge features (b, N, K, 9) over the periodic kNN graph: the min-image
offset to each neighbor with the ZA displacement on the self edge (slot
0), the particle's own ZA velocity (the row's) and the neighbor's (the
column's).  The layers are reference/shiftinv.py's equations: per layer
op 1 h W1; op 2 the mean of the edges that point at each particle,
gathered back to the edges by neighbor id, W2; op 3 the mean over the K
edges of each row, W3; op 4 the mean over all edges, W4; plus the bias;
ReLU between layers, a mean over K after the last.  The output (b, N, 6)
is the displacement residual scaled by T[0] and the velocity residual by
T[1]; the loss is loss_za over all six columns.  Departures from the
reference: the graph is the lattice search's (common.lattice_knn), as in
the port; the mean of op 2 divides by the in-degree (an empty segment
gives 0), as tf.unsorted_segment_mean does; T starts at 0.002, the init
of the reference's scalar parameters (utils.py:182), which the commented
model consumed as loc_scalar and vel_scalar but whose own init it does
not give.  ``cast`` rounds the inputs, the weights,
T and each layer's output (the control's lower precision); the identity
keeps float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from benchmark_torch.reference import common

# weights and biases a layer (W (4, C, q), B (1, q))
NUM_WEIGHTS, NUM_BIASES = 4, 1
# the output scalars' start (loc, vel)
T_INIT = 0.002


def make_forward(cfg: dict, window: int) -> Callable:
    """forward({"layers": [{"W", "B"}, ...], "T": (2,)}, x_in (b, N, 9),
    cast) -> (b, N, 6), for the configuration's cube and K at lattice
    `window`."""
    cells, k = cfg["cells"], cfg["k_neighbors"]
    box = 4.0 * cells
    n = cells ** 3

    def forward(params: dict, x_in: torch.Tensor,
                cast: Callable = common.identity) -> torch.Tensor:
        pos, za, pos_norm = common.graph_geometry(x_in, box)
        with torch.no_grad():
            idx = common.lattice_knn(pos_norm, k, cells, window)
            deg = torch.clamp_min(common.in_degree(idx, n), 1.0)[..., None]
        pos, za, vel = cast(pos), cast(za), cast(x_in[..., 6:9])
        rel = common.min_image(common.gather(pos, idx) - pos[:, :, None, :], box)
        geo = torch.cat([za[:, :, None, :], rel[:, :, 1:, :]], dim=2)
        rows = vel[:, :, None, :].expand(-1, -1, k, -1)
        h = cast(torch.cat([geo, rows, common.gather(vel, idx)], dim=-1))
        layers = params["layers"]
        for i, layer in enumerate(layers):
            w, bias = cast(layer["W"]), cast(layer["B"])[0]
            pooled = common.segment_sum(h, idx, n) / deg
            row_mean = torch.mean(h, dim=2)
            out = (h @ w[0] + common.gather(pooled, idx) @ w[1]
                   + (row_mean @ w[2])[:, :, None, :]
                   + (torch.mean(row_mean, dim=1) @ w[3])[:, None, None, :] + bias)
            if i < len(layers) - 1:
                h = cast(torch.relu(out))
        net = cast(torch.mean(out, dim=2))
        t = cast(params["T"])
        return cast(torch.cat([net[..., :3] * t[0], net[..., 3:] * t[1]], dim=-1))

    return forward


def train_steps(forward: Callable, layers: List[Dict[str, torch.Tensor]],
                t: torch.Tensor, batches, lr: float,
                cast: Callable = common.identity, batch_keep: float = 1.0):
    """common.train_steps over the leaves W0..W{L-1}, B0..B{L-1}, T: the
    reference's train steps from `layers` and `t` (float32, not modified)
    over `batches` [(x_in (b, N, 9), target (b, N, 6)), ...] -> (losses,
    first gradients, parameter changes, each step's per-cube losses), a
    step's gradient accumulated cube by cube; ``batch_keep`` < 1 keeps
    only the first share of each batch (a planted fault)."""
    nl = len(layers)
    leaves = ([layers[i]["W"].detach().clone() for i in range(nl)]
              + [layers[i]["B"].detach().clone() for i in range(nl)]
              + [t.detach().clone()])
    start = [p.clone() for p in leaves]
    adam = common.Adam(leaves, lr)
    losses, first, per_cube = [], None, []
    for x_in, target in batches:
        keep = max(1, int(round(x_in.shape[0] * batch_keep)))
        grads = [torch.zeros_like(p) for p in leaves]
        total = 0.0
        per_cube.append([])
        for j in range(keep):
            p = [q.detach().requires_grad_(True) for q in leaves]
            cur = {"layers": [{"W": p[i], "B": p[nl + i]} for i in range(nl)],
                   "T": p[-1]}
            loss = common.loss_za(forward(cur, x_in[j:j + 1], cast),
                                  target[j:j + 1]) / keep
            for acc, g in zip(grads, torch.autograd.grad(loss, p)):
                acc.add_(g)
            total += float(loss.detach())
            per_cube[-1].append(float(loss.detach()) * keep)
        losses.append(total)
        if first is None:
            first = [g.clone() for g in grads]
        adam.step(grads)
    return losses, first, [p - p0 for p, p0 in zip(leaves, start)], per_cube
