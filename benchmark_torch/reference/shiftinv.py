"""Plain float32 reference of the 4-op shift-invariant graph network
(reference graph.py:367-515; BASELINE.json configs 2 and 3).

Per layer, on edge features h (b, N, K, C) over the periodic kNN graph:
op 1 h W1; op 2 the mean of the edges that point at each particle,
gathered back to the edges by neighbor id, W2; op 3 the mean over the K
edges of each row, W3; op 4 the mean over all edges, W4; plus the bias;
ReLU between layers, a mean over K after the last.  Edge features: the
min-image offset to each neighbor, the ZA displacement on the self edge
(slot 0).  Departures from the reference: the graph is the lattice
search's (common.lattice_knn), as in the port; the mean of op 2 divides
by the in-degree (an empty segment gives 0), as tf.unsorted_segment_mean
does.  ``cast`` rounds the inputs, the weights and each layer's output
(the control's lower precision); the identity keeps float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from benchmark_torch.reference import common

# weights and biases a layer (W (4, C, q), B (1, q))
NUM_WEIGHTS, NUM_BIASES = 4, 1


def make_forward(cfg: dict, window: int) -> Callable:
    """forward(layers, x_in (b, N, 6), cast) -> (b, N, 3) predicted
    residual, for the configuration's cube and K at lattice `window`."""
    cells, k = cfg["cells"], cfg["k_neighbors"]
    box = 4.0 * cells
    n = cells ** 3

    def forward(layers: List[Dict[str, torch.Tensor]], x_in: torch.Tensor,
                cast: Callable = common.identity) -> torch.Tensor:
        pos, za, pos_norm = common.graph_geometry(x_in, box)
        with torch.no_grad():
            idx = common.lattice_knn(pos_norm, k, cells, window)
            deg = torch.clamp_min(common.in_degree(idx, n), 1.0)[..., None]
        pos, za = cast(pos), cast(za)
        rel = common.min_image(common.gather(pos, idx) - pos[:, :, None, :], box)
        h = cast(torch.cat([za[:, :, None, :], rel[:, :, 1:, :]], dim=2))
        for i, layer in enumerate(layers):
            w, bias = cast(layer["W"]), cast(layer["B"])[0]
            pooled = common.segment_sum(h, idx, n) / deg
            rows = torch.mean(h, dim=2)
            out = (h @ w[0] + common.gather(pooled, idx) @ w[1]
                   + (rows @ w[2])[:, :, None, :]
                   + (torch.mean(rows, dim=1) @ w[3])[:, None, None, :] + bias)
            if i == len(layers) - 1:
                return cast(torch.mean(out, dim=2))
            h = cast(torch.relu(out))
        raise ValueError("no layers")

    return forward
