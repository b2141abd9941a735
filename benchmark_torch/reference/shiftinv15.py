"""Plain float32 reference of the 15-operator shift-invariant graph
network (reference graph.py:20-229; the basis of the 15 linear
equivariant operators on edge-valued functions, openreview Syx72jC9tm).

The graph is the symmetrized kNN adjacency, held as two blocks of
(N, K) edge slots a sample: block A the directed kNN edges n -> idx[n,k]
(self at slot 0), block B the reversed edges idx[n,k] -> n, masked out
(mask_b = 0) where the reverse already is an A edge.  With deg the
symmetrized degree (K + the live B edges that point at a particle) and
live = sum(deg), a layer's pools (named as the JAX package names them) are
  h_r  (scatter_by_idx(h_A) + sum_K h_B) / deg,
  h_c  (sum_K h_A + scatter_by_idx(h_B)) / deg,
  h_a  mean of all live edges,  h_d  the diagonal h_A[:, 0],
  h_p  the mean of the diagonal,
and the layer is
  h W1 + T(h) W2 + col(h_r W4 + h_c W8 + h_d W14) + row(h_r W5 + h_c W7
  + h_d W15) + diag(h_d W3 + h_r W6 + h_c W9 + h_a W11 + h_p W13 + b_d)
  + h_a W10 + h_p W12 + b_g,
masked to the live slots, where T is the edge transpose (an A slot takes
the value of its reverse A edge where one exists, else its B mirror; a B
slot its A mirror), col / row broadcast a particle field to the edges by
column / row id, and diag writes the self slots of block A.  ReLU between
layers; the last layer's edges are pooled as h_c pools them.  Edge features: block
A the min-image offsets with the ZA displacement on the self edge, block
B their negation.  Departures from the reference: the lattice search's
graph, as in the port; no float64 or dynamic edge lists.  ``cast`` rounds
the inputs, the weights and each layer's output.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from benchmark_torch.reference import common

# weights and biases a layer (W (15, C, q), B (2, q))
NUM_WEIGHTS, NUM_BIASES = 15, 2


def sym_graph(idx: torch.Tensor, n: int):
    """idx (b, N, K) int64 -> (rev_pos, mask_b, deg): the slot of the
    reverse A edge (0 where none), 1.0 where the B edge is live, and the
    symmetrized degree (b, N)."""
    k = idx.shape[-1]
    back = common.gather(idx, idx)                                # (b, N, K, K)
    me = torch.arange(n, device=idx.device)[None, :, None, None]
    hit = back == me
    exists = hit.any(dim=-1)
    slots = torch.arange(k, device=idx.device)
    rev_pos = torch.where(exists, torch.where(hit, slots, k).amin(dim=-1), 0)
    mask_b = (~exists).to(torch.float32)
    deg = k + common.segment_sum(mask_b[..., None], idx, n)[..., 0]
    return rev_pos, mask_b, deg


def make_forward(cfg: dict, window: int) -> Callable:
    """forward(layers, x_in (b, N, 6), cast) -> (b, N, 3)."""
    cells, k = cfg["cells"], cfg["k_neighbors"]
    box = 4.0 * cells
    n = cells ** 3

    def forward(layers: List[Dict[str, torch.Tensor]], x_in: torch.Tensor,
                cast: Callable = common.identity) -> torch.Tensor:
        pos, za, pos_norm = common.graph_geometry(x_in, box)
        b = x_in.shape[0]
        with torch.no_grad():
            idx = common.lattice_knn(pos_norm, k, cells, window)
            rev_pos, mask_b, deg = sym_graph(idx, n)
            live = torch.sum(deg, dim=1)                           # (b,)
            # flat ids of each slot's reverse A edge in the (b, N*K) table
            rev_ids = idx * k + rev_pos
        mb = mask_b[..., None]
        pos, za = cast(pos), cast(za)
        rel = common.min_image(common.gather(pos, idx) - pos[:, :, None, :], box)
        ha = torch.cat([za[:, :, None, :], rel[:, :, 1:, :]], dim=2)
        h = cast(torch.stack([ha, -rel * mb], dim=1))             # (b, 2, N, K, 3)

        def transpose(x):
            xa, xb = x[:, 0], x[:, 1]
            c = x.shape[-1]
            table = xa.reshape(b, n * k, c)
            from_a = common.gather(table, rev_ids.reshape(b, n * k, 1)).reshape(xa.shape)
            return torch.stack([from_a * (1.0 - mb) + xb * mb, xa * mb], dim=1)

        def col(x):          # particle field -> edges, by column id
            g = common.gather(x, idx)
            return torch.stack([g, x[:, :, None, :].expand_as(g)], dim=1)

        def row(x):          # particle field -> edges, by row id
            g = common.gather(x, idx)
            return torch.stack([x[:, :, None, :].expand_as(g), g], dim=1)

        def pool_c(x):
            return (torch.sum(x[:, 0], dim=2)
                    + common.segment_sum(x[:, 1] * mb, idx, n)) / deg[..., None]

        for i, layer in enumerate(layers):
            w, bias = cast(layer["W"]), cast(layer["B"])
            xa, xbm = h[:, 0], h[:, 1] * mb
            h_r = (common.segment_sum(xa, idx, n) + torch.sum(xbm, dim=2)) / deg[..., None]
            h_c = pool_c(h)
            h_a = (torch.sum(xa, dim=(1, 2)) + torch.sum(xbm, dim=(1, 2))) / live[:, None]
            h_d = xa[:, :, 0, :]
            h_p = torch.mean(h_d, dim=1)
            out = (h @ w[0] + transpose(h) @ w[1]
                   + col(h_r @ w[3] + h_c @ w[7] + h_d @ w[13])
                   + row(h_r @ w[4] + h_c @ w[6] + h_d @ w[14])
                   + (h_a @ w[9] + h_p @ w[11] + bias[1])[:, None, None, None, :])
            diag = (h_d @ w[2] + h_r @ w[5] + h_c @ w[8]
                    + (h_a @ w[10] + h_p @ w[12] + bias[0])[:, None, :])
            sel = torch.zeros(out.shape[1:4] + (1,), dtype=torch.bool, device=out.device)
            sel[0, :, 0] = True
            out = out + torch.where(sel, diag[:, None, :, None, :], 0.0)
            out = out * torch.stack([torch.ones_like(mask_b), mask_b], dim=1)[..., None]
            if i == len(layers) - 1:
                return cast(pool_c(out))
            h = cast(torch.relu(out))
        raise ValueError("no layers")

    return forward
