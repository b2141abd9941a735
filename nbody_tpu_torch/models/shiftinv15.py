"""Shift-invariant graph network, full 15-operator equivariant basis (port
of nbody_tpu/models/shiftinv15.py; reference graph.py:20-229).

The symmetrized adjacency is block-structured, (b, 2, N, K) edge slots:
block A holds the directed kNN edges n -> idx[n, k], block B the reversed
edges idx[n, k] -> n, masked where the reverse already exists in block A.
Most of the 15 operators are then reshapes and means (row pools over
block A, the diagonal at the guaranteed self slot 0, global and diagonal
pools); the rest are the route's neighbor gathers and scatters.

The edge transpose (op 2) is one reverse-edge lookup: the value at (n, k)
is h_a[idx[n, k], rev_pos[n, k]], a plain indexed load of the flattened
(b, N*K, C) edge table at ids idx*K + rev_pos -- one launch of kernel B
at K' = 1, whose gradient is kernel C over the ids' GraphPlan, built once
a forward and shared by every layer, backward included.  JAX instead
gathers K*C-wide rows through the route's one-hot kernel and contracts
them against onehot(rev_pos), or scans or scatters by slot
(TRANSPOSE_IMPL), because one composed selection would need a P*K-wide
one-hot on the TPU; it sums one nonzero product and K-1 exact zeros, so
the lookup gives the same bits in f32 and bf16, and moves K times fewer
bytes.  A non-mutual edge looks up slot 0 of its neighbor, which the
layer multiplies by rev_exists = 0.  The lookup is itself a direct route
(ops/route.py) over the flat ids.  On the block-major routes it runs
over block-major edge ids.

Two network forms, as in JAX, picked by the step's route: the cube form
(``shift_inv_15op_layer``) on the direct, banded and block routes, and
the block-major form (``_shift_inv_15op_layer_blocks``) on the masked
index and int8/int4 routes, which keeps edge activations block-major
between layers and runs exactly one fused scatter ([h_a | masked h_b],
2C wide) and one fused gather ([x_col | x_row], 2q wide) through the
masks a layer.  The cube
form's edge-wise work after its products and gathers (the transpose's
select, the broadcast stacks, the pooled and diagonal terms, the block
mask and relu) is one pass each way, ops/kernels/edge_epilogue, and so
is the transpose before the product where a layer widens.  Dtypes
follow JAX's promotions step by step: the cube form's f32 graph fields
(mask_b, deg) promote the edge tensors they touch to f32, and the
block-major form casts its pool results back to the edge dtype.  With
``remat`` each layer is recomputed in the backward pass
(base.remat_layer).  Into an open step timeline (tracing.py) the model
marks ``plan`` after the route's plan, the graph and the lookup,
``features``, and probes each layer's output, outside the remat wrapper.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.models.base import (LayerParams, init_network_params,
                                         remat_layer)
from nbody_tpu_torch.ops.graph_features import neighbor_positions
from nbody_tpu_torch.ops.kernels import banded_kernels as K
from nbody_tpu_torch.ops.kernels.banded_kernels import GraphPlan, graph_plan
from nbody_tpu_torch.ops.kernels.edge_epilogue import edge_epilogue, edge_transpose
from nbody_tpu_torch.ops.route import Route
from nbody_tpu_torch.physics.pbc import min_image_diff

# neighbor ids travel through the f32 gather of the reverse-edge search:
# exact only below 2^24
MAX_PARTICLES = 2 ** 24


def init_shiftinv15_params(generator: torch.Generator,
                           channels) -> LayerParams:
    """Per layer: W (15, k_in, k_out), B (2, k_out) = [diag bias, global
    bias] (shiftinv15.py:98-103)."""
    return init_network_params(generator, channels, num_weights=15,
                               num_biases=2)


class BlockSymGraph(NamedTuple):
    """Batched block-structured symmetrized kNN graph (shiftinv15.py:110-115)."""
    idx: torch.Tensor        # (b, N, K) int32 neighbor ids, self at slot 0
    rev_pos: torch.Tensor    # (b, N, K) int32 j with idx[c, j] == n (else 0)
    mask_b: torch.Tensor     # (b, N, K) f32, 1 where the reversed edge is live
    deg: torch.Tensor        # (b, N) f32 symmetrized degree


@torch.no_grad()
def build_block_sym_graph(idx: torch.Tensor, plan: GraphPlan = None) -> BlockSymGraph:
    """idx (b, N, K) with self at slot 0 -> BlockSymGraph, by the id path
    of shiftinv15.py:153-169 on every route: kernel B gathers each
    neighbor's id row (K wide, f32, exact below 2^24), rounded and compared
    with the row's own id; rev_pos is the first hit.  deg = K + kernel C
    of mask_b at width 1 over `plan` (graph_plan(idx), the direct route's
    plan when given).  JAX's lattice path (offset triplets) builds the
    same graph."""
    b, n, k = idx.shape
    if n > MAX_PARTICLES:
        raise ValueError(f"the reverse-edge search gathers ids in f32: "
                         f"N={n} exceeds 2^24")
    plan = plan if plan is not None else graph_plan(idx)
    nbr = torch.round(K.neighbor_gather(idx.to(torch.float32), idx)).to(torch.int32)
    particles = torch.arange(n, dtype=torch.int32, device=idx.device)
    hit = nbr == particles[None, :, None, None]                 # (b, N, K, K)
    rev_exists = hit.any(dim=-1)
    slots = torch.arange(k, dtype=torch.int32, device=idx.device)
    first = torch.where(hit, slots, k).amin(dim=-1)
    rev_pos = torch.where(rev_exists, first, 0).to(torch.int32)
    mask_b = (~rev_exists).to(torch.float32)
    cnt_b = K.neighbor_segment_sum(mask_b[..., None].contiguous(), plan)[..., 0]
    return BlockSymGraph(idx=idx, rev_pos=rev_pos, mask_b=mask_b,
                         deg=cnt_b + float(k))


@torch.no_grad()
def reverse_lookup(graph: BlockSymGraph, route: Route) -> Route:
    """The transpose's lookup: the direct route over the flat edge-table
    ids (b, N*K, 1) int32 of the source edge of every destination edge --
    idx*K + rev_pos into the cube-order table, or, on a masked `route`,
    block-major ids into the block-major table (edge (blk, r, k) of node m
    sits at row bm(m)*K + k, bm the node's block-major position), in
    block-major destination order."""
    idx, rev_pos = graph.idx, graph.rev_pos
    b, n, k = idx.shape
    if not route.block_major:
        ids = idx * k + rev_pos
    else:
        nodes = torch.arange(n, dtype=torch.int32, device=idx.device)
        order = route.to_blocks(nodes[None, :, None]).reshape(n)
        bm = torch.empty_like(order)
        bm[order.long()] = nodes
        ids = route.to_blocks(bm[idx.long()] * k + rev_pos)
    return Route.direct(ids.reshape(b, n * k, 1).to(torch.int32).contiguous())


def reverse_edges(h_a: torch.Tensor, lookup: Route) -> torch.Tensor:
    """(b, ..., K, C) block-A edge values -> the value of each edge's
    reverse, h_a[idx, rev_pos], same shape: one kernel B launch over the
    flattened table (its gradient: kernel C over the lookup's plan)."""
    shape = h_a.shape
    table = h_a.reshape(shape[0], -1, shape[-1])
    return lookup.gather(table).reshape(shape)


def block_edge_features_za(pos: torch.Tensor, graph: BlockSymGraph,
                           za_disp: torch.Tensor, box: float,
                           route: Route) -> torch.Tensor:
    """(b, N, 3) pos -> (b, 2, N, K, 3) block edge features
    (shiftinv15.py:174-189): block A the min-image relative positions with
    the ZA displacement on the self edge, block B their negation, masked."""
    nbr = neighbor_positions(pos, route, box)
    edges = min_image_diff(nbr, pos[:, :, None, :], box)
    ea = torch.cat([za_disp[:, :, None, :], edges[:, :, 1:, :]], dim=2)
    eb = (-edges) * graph.mask_b[..., None]
    return torch.stack([ea.to(eb.dtype), eb], dim=1)


def _mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """jnp.einsum("...c,cq->...q", x, w, preferred_element_type=dt): the
    product in the operands' promoted dtype, returned in dt."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(ct), w.to(ct)).to(dt)


def _with_diag(out: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """out (b, 2, ..., K, q) with the diagonal (self) slots of block A,
    out[:, 0, ..., 0, :], replaced by diag (b, ..., q); out of place."""
    sel = torch.zeros(out.shape[1:-1] + (1,), dtype=torch.bool,
                      device=out.device)
    sel[0, ..., 0, :] = True
    return torch.where(sel, diag[:, None, ..., None, :], out)


def _row_pool(h: torch.Tensor, g: BlockSymGraph, route: Route) -> torch.Tensor:
    """Mean over edges grouped by row id -> (b, N, C): block A sums over K,
    block B scatters its masked values (shiftinv15.py:196-205)."""
    sums = torch.sum(h[:, 0], dim=2)
    sums = sums + route.scatter_add(h[:, 1] * g.mask_b[..., None])
    return sums / g.deg[..., None]


def shift_inv_15op_layer(h: torch.Tensor, graph: BlockSymGraph,
                         layer_params: Dict[str, torch.Tensor], route: Route,
                         lookup: Route, is_last: bool = False,
                         activation: Callable = None) -> torch.Tensor:
    """One 15-op layer in cube form (shiftinv15.py:281-345) on the direct,
    banded and block routes.  h (b, 2, N, K, C) masked block edge
    features; returns (b, 2, N, K, q), activated by `activation` unless
    is_last, or (b, N, q) pooled over rows if is_last.  route: the step's
    route of graph.idx; lookup: the transpose's (reverse_lookup of the
    cube ids).  Every addition keeps JAX's order and dtype
    promotion; the diagonal contributions land on the self slots in the
    order of JAX's _at_dia adds.  The edge-wise work after the products
    and the gathers is one pass (ops/kernels/edge_epilogue: on a card one
    kernel each way, relu included where `activation` is torch.relu), and
    so is the transpose before the product where the layer widens."""
    w = layer_params["W"]        # (15, C, q)
    bias = layer_params["B"]     # (2, q): [diag, global]
    dt = h.dtype
    g = graph

    def mm(x, wi):
        return _mm(x, wi, dt)

    c_in = h.shape[-1]
    mb = g.mask_b[..., None]
    h_d = h[:, 0, :, 0, :]                       # (b, N, C) diagonal
    # both pools in one scatter: block A by column id, masked block B by
    # row id, channel-concatenated
    hb_m = h[:, 1] * mb
    s2 = route.scatter_add(torch.cat([h[:, 0].to(hb_m.dtype), hb_m], dim=-1))
    sum_a = torch.sum(h[:, 0], dim=2)
    h_r = (s2[..., :c_in] + torch.sum(hb_m, dim=2)) / g.deg[..., None]
    h_c = (sum_a + s2[..., c_in:]) / g.deg[..., None]
    live = torch.sum(g.deg, dim=-1)              # live edges per sample
    h_a = (torch.sum(h[:, 0], dim=(1, 2))
           + torch.sum(hb_m, dim=(1, 2))) / live[:, None]
    h_p = torch.mean(h_d, dim=1)                 # (b, C)

    p0 = mm(h, w[0])                                             # 1 identity
    # ops 4, 8, 14 share one col-broadcast gather, 5, 7, 15 one row one
    x_col = mm(h_r, w[3]) + mm(h_c, w[7]) + mm(h_d, w[13])
    x_row = mm(h_r, w[4]) + mm(h_c, w[6]) + mm(h_d, w[14])
    if w.shape[-1] < w.shape[-2]:           # 2 transpose, after the product
        t = mm(h, w[1])
        rev = reverse_edges(t[:, 0], lookup)
    else:                                   # before it
        t = mm(edge_transpose(h, reverse_edges(h[:, 0], lookup), g.mask_b),
               w[1])
        rev = None
    g_col = route.gather(x_col)
    g_row = route.gather(x_row)
    relu = activation is torch.relu and not is_last
    out = edge_epilogue(
        p0, t, rev, g_col, g_row, x_col, x_row,
        mm(h_d, w[2]), mm(h_r, w[5]), mm(h_c, w[8]),             # 3, 6, 9
        mm(h_a, w[9]), mm(h_a, w[10]),                           # 10, 11
        mm(h_p, w[11]), mm(h_p, w[12]),                          # 12, 13
        bias[0], bias[1], g.mask_b, relu=relu)
    if is_last:
        return _row_pool(out, g, route)
    if activation is not None and not relu:
        out = activation(out)
    return out


def _shift_inv_15op_layer_blocks(hB: torch.Tensor, layer_params, route: Route,
                                 mbB: torch.Tensor, deg: torch.Tensor,
                                 live: torch.Tensor, lookup: Route,
                                 is_last: bool) -> torch.Tensor:
    """The 15-op layer on BLOCK-MAJOR edges hB (b, 2, NB, R, K, C) over the
    masked routes (shiftinv15.py:348-540, its "gather" form with the
    transpose as the block-major reverse-edge lookup): one fused scatter
    (2C wide) and one fused gather (2q wide) through the masks; the five
    diagonal contributions and the diag bias as one node field.  Pool
    divisions run against f32 deg and live and are cast back to the edge
    dtype.  Returns the next hB, or the cube (b, N, q) if is_last."""
    w = layer_params["W"]        # (15, C, q)
    bias = layer_params["B"]     # (2, q)
    dt = hB.dtype
    c_in, q = hB.shape[-1], w.shape[-1]
    to_cube, to_blocks = route.to_cube, route.to_blocks
    scatter = route.scatter_edges        # block-major edges -> cube sums

    def mm(x, wi):
        return _mm(x, wi, dt)

    pre_w = q < c_in
    if pre_w:
        # ops 1 and 2 share the edge-level operand: one product
        o12 = mm(hB, torch.cat([w[0], w[1]], dim=1))
        out, hinB = o12[..., :q], o12[..., q:]
    else:
        out, hinB = mm(hB, w[0]), hB                    # 1 identity

    mb = mbB[..., None]
    hbm = hB[:, 1] * mb
    s2 = scatter(torch.cat([hB[:, 0], hbm], dim=-1))    # cube (b, N, 2C)
    sum_a = to_cube(torch.sum(hB[:, 0], dim=3))         # (b, N, C)
    sum_bm = to_cube(torch.sum(hbm, dim=3))
    h_r = ((s2[..., :c_in] + sum_bm) / deg[..., None]).to(dt)
    h_c = ((sum_a + s2[..., c_in:]) / deg[..., None]).to(dt)
    h_d = to_cube(hB[:, 0, :, :, 0, :])                 # diagonal (b, N, C)
    h_a = ((torch.sum(sum_a, dim=1) + torch.sum(sum_bm, dim=1))
           / live[:, None]).to(dt)
    h_p = torch.mean(h_d, dim=1)                        # (b, C)

    x_col = mm(h_r, w[3]) + mm(h_c, w[7]) + mm(h_d, w[13])
    x_row = mm(h_r, w[4]) + mm(h_c, w[6]) + mm(h_d, w[14])
    ggB = route.gather_edges(torch.cat([x_col, x_row], dim=-1))  # (b, NB, R, K, 2q)
    taB = reverse_edges(hinB[:, 0], lookup) * (1.0 - mb) + hinB[:, 1] * mb
    tB = torch.stack([taB, hinB[:, 0] * mb], dim=1)
    if not pre_w:
        tB = mm(tB, w[1])
    out = out + tB                                      # 2 transpose
    x_colB, x_rowB = to_blocks(x_col), to_blocks(x_row)
    out = out + torch.stack([ggB[..., :q] + x_rowB[:, :, :, None, :],
                             x_colB[:, :, :, None, :] + ggB[..., q:]], dim=1)
    # all five diagonal contributions + diag bias as one node field
    diag = (mm(h_d, w[2]) + mm(h_r, w[5]) + mm(h_c, w[8])        # 3, 6, 9
            + (mm(h_a, w[10]) + mm(h_p, w[12]) + bias[0])[:, None, :])
    out = _with_diag(out, out[:, 0, :, :, 0, :] + to_blocks(diag))
    out = out + (mm(h_a, w[9]) + mm(h_p, w[11]) + bias[1])[
        :, None, None, None, None, :]                   # 10, 12
    out = out * torch.stack([torch.ones_like(mbB), mbB], dim=1)[..., None]
    if is_last:
        # row pool: block A sums over K, block B masked scatter
        s = scatter(out[:, 1] * mb)
        return ((to_cube(torch.sum(out[:, 0], dim=3)) + s)
                / deg[..., None]).to(dt)
    return out


def _shiftinv15_network_blocks(params, edges: torch.Tensor,
                               graph: BlockSymGraph, route: Route,
                               lookup: Route, activation: Callable,
                               remat: bool) -> torch.Tensor:
    """Masked-route network (shiftinv15.py:543-581): block-major edge
    activations end to end, over the lookup of block-major ids."""
    b, _, n, k, c = edges.shape
    hB = route.to_blocks(edges.reshape(b * 2, n, k * c))
    nb, r = hB.shape[1], hB.shape[2]
    hB = hB.reshape(b, 2, nb, r, k, c)
    mbB = route.to_blocks(graph.mask_b.to(edges.dtype))
    # f32 whatever the compute dtype: the pool divisions
    deg = graph.deg.to(torch.float32)
    live = torch.sum(deg, dim=-1)
    layer = remat_layer(_shift_inv_15op_layer_blocks, remat)
    for i, layer_params in enumerate(params):
        is_last = i == len(params) - 1
        hB = layer(hB, layer_params, route, mbB, deg, live, lookup, is_last)
        if not is_last:
            hB = activation(hB)
        hB = tracing.probe(hB, f"layer{i}")
    return hB


def shiftinv15_network(params: List[Dict[str, torch.Tensor]],
                       edges: torch.Tensor, graph: BlockSymGraph, route: Route,
                       lookup: Route, activation: Callable = torch.relu,
                       remat: bool = False) -> torch.Tensor:
    """Layer stack (reference network_func_15op_shift_inv_za;
    shiftinv15.py:584-605) over the transpose's `lookup`
    (reverse_lookup): the block-major form on the masked routes, else
    the cube form."""
    if route.block_major:
        return _shiftinv15_network_blocks(params, edges, graph, route, lookup,
                                          activation, remat)
    layer = remat_layer(shift_inv_15op_layer, remat)
    h = edges
    for i, layer_params in enumerate(params):
        h = layer(h, graph, layer_params, route, lookup,
                  i == len(params) - 1, activation)
        h = tracing.probe(h, f"layer{i}")
    return h


def shiftinv15_model(params, pos: torch.Tensor, za_disp: torch.Tensor,
                     route: Route, box: float,
                     activation: Callable = torch.relu,
                     remat: bool = False) -> torch.Tensor:
    """Symmetrized graph + features + network (shiftinv15.py:608-624).
    pos (b, N, 3) raw positions, za_disp (b, N, 3), the route of idx
    (b, N, K) with self at slot 0 (its plan built before) -> (b, N, q).
    The graph and the transpose's lookup are built once, before the
    features; the direct route's GraphPlan also serves the graph's degree
    scatter."""
    graph = build_block_sym_graph(route.idx, route.graph_plan)
    lookup = reverse_lookup(graph, route)
    tracing.mark("plan")
    feats = block_edge_features_za(pos, graph, za_disp, box, route)
    tracing.mark("features")
    return shiftinv15_network(params, feats.to(pos.dtype), graph, route,
                              lookup, activation, remat)
