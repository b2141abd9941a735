"""The neighbor route of one forward: the kernels every neighbor gather and
scatter of a step runs on, and the one plan they share (port of the
batched dispatch of nbody_tpu/ops/banded.py:178-322 and of the
``lattice`` / ``masks`` arguments the JAX models carry).

models/registry._make_route decides the route once a forward and passes
the ``Route`` down to the features and the layers; its methods dispatch
on nothing.  The kinds:

  * ``direct`` and ``banded``: kernels B/C over a GraphPlan (the edges
    sorted by target).  ``banded`` (``--impl banded``) runs the same
    kernels, recorded apart: their exact (band=None) semantics are what
    the banded kernels compute under lattice kNN anyway
    (nbody_tpu/ops/banded.py:37-46).
  * ``block`` (``--impl block``): kernels F/G over the BlockPlan of CORE
    blocks, with ``fast`` = (values are bf16): exact in either dtype, the
    JAX CPU semantics (on the TPU it rounded f32 values to bf16).  A cube
    that CORE does not tile runs kernels B/C, recorded as ``block``.
  * ``index``, ``int8`` and ``int4`` (the masked routes): kernels D/E over
    the BlockPlan of per-edge patch positions, or H/I over int8 / packed
    int4 one-hot masks, at the route's core, with the self slot dropped
    from the plan and copied outside the kernels.  The network keeps edge
    activations block-major, (b, NB, R, K, C), between layers.

``gather`` / ``scatter_add`` work in cube layout; ``gather_edges`` /
``scatter_edges`` / ``segment_mean`` in the network's layout, which
``edges_in`` enters and ``nodes_out`` leaves (identities on the cube
routes).  On the direct and block routes each op's gradient is the other
op over the same plan, as in the JAX custom VJPs
(nbody_tpu/ops/banded.py:221-254); the masked routes differentiate
through ops/blocked's patch views and the kernels' own autograd pairs.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.kernels import banded_kernels as K
from nbody_tpu_torch.ops.kernels.banded_kernels import graph_plan

MASKED_KINDS = ("index", "int8", "int4")


def _save(ctx, route):
    ctx.save_for_backward(route.idx, *route.plan)
    ctx.route = route


def _saved(ctx):
    idx, *plan = ctx.saved_tensors
    return ctx.route, idx, type(ctx.route.plan)(*plan)


class NeighborGather(torch.autograd.Function):
    """values (b, N, C) -> (b, N, K, C) over a direct or block route; grad:
    the route's scatter-add over the same plan."""

    @staticmethod
    def forward(ctx, values, route):
        _save(ctx, route)
        return route._gather(values.contiguous(), route.idx, route.plan)

    @staticmethod
    def backward(ctx, ct):
        route, idx, plan = _saved(ctx)
        return route._scatter(ct.contiguous(), idx, plan), None


class NeighborScatterAdd(torch.autograd.Function):
    """vals (b, N, K, C) -> (b, N, C) summed by target over a direct or
    block route; grad: the route's gather."""

    @staticmethod
    def forward(ctx, vals, route):
        _save(ctx, route)
        return route._scatter(vals.contiguous(), route.idx, route.plan)

    @staticmethod
    def backward(ctx, ct):
        route, idx, plan = _saved(ctx)
        return route._gather(ct.contiguous(), idx, plan), None


class Route:
    """The direct kernels B/C over ``plan``, the GraphPlan of ``idx``
    (b, N, K) int32.  Build routes with ``Route.direct``, ``Route.block``
    and ``Route.masked``."""

    block_major = False     # the network's layout: cube order

    def __init__(self, kind: str, idx: torch.Tensor, plan, cells: int = 0,
                 window: int = 0, core=None, downgrade=None):
        self.kind, self.idx, self.plan = kind, idx, plan
        self.cells, self.window, self.core = cells, window, core
        self.downgrade = downgrade

    @staticmethod
    def direct(idx: torch.Tensor, kind: str = "direct", downgrade=None) -> "Route":
        """Kernels B/C over graph_plan(idx), for any ids (not only a cube's)."""
        return Route(kind, idx, graph_plan(idx), downgrade=downgrade)

    @staticmethod
    def block(idx: torch.Tensor, cells: int, window: int,
              downgrade=None) -> "Route":
        """Kernels F/G over the BlockPlan of CORE blocks, where CORE tiles
        the cube idx holds; else kernels B/C, recorded as the block route."""
        core = blocked.CORE
        if idx.shape[1] != cells ** 3 or any(cells % d for d in core):
            return Route("block", idx, graph_plan(idx), cells, window, core,
                         downgrade)
        return _BlockRoute("block", idx,
                           blocked.block_index_plan(idx, cells, window, core),
                           cells, window, core, downgrade)

    @staticmethod
    def masked(kind: str, idx: torch.Tensor, cells: int, window: int,
               core) -> "Route":
        """The masked route `kind` ("index", "int8" or "int4") at `core`:
        its BlockPlan or masks built here, the self slot dropped."""
        core = tuple(core)
        if kind == "index":
            plan = blocked.block_index_plan(idx, cells, window, core=core,
                                            drop_self_slot0=True)
        else:
            plan = blocked.block_masks(
                idx, cells, window, core=core, drop_self_slot0=True,
                dtype=torch.int8 if kind == "int8" else "int4")
        return _MaskedRoute(kind, idx, plan, cells, window, core)

    def record(self) -> dict:
        """The route as models/registry records it in ``impl_record``."""
        rec = dict(impl="masked" if self.block_major else self.kind,
                   core=list(self.core) if self.core else None,
                   mask_dtype=self.kind if self.block_major else None,
                   downgrade=self.downgrade)
        if self.kind in ("int8", "int4"):
            rec["mask_bytes"] = self.plan.numel() * self.plan.element_size()
        return rec

    @property
    def graph_plan(self):
        """The route's GraphPlan, or None where it runs over another plan."""
        return self.plan

    def _gather(self, values, idx, plan):
        return K.neighbor_gather(values, idx)

    def _scatter(self, vals, idx, plan):
        return K.neighbor_scatter_add(vals, idx, plan)

    def gather(self, values: torch.Tensor) -> torch.Tensor:
        """values (b, N, C) -> (b, N, K, C): values at each neighbor id."""
        return NeighborGather.apply(values, self)

    def scatter_add(self, edges: torch.Tensor) -> torch.Tensor:
        """edges (b, N, K, C) -> (b, N, C) summed by neighbor id."""
        return NeighborScatterAdd.apply(edges, self)

    def counts(self, dtype=torch.float32) -> torch.Tensor:
        """In-degree (b, N) of every particle, in `dtype`: off the plan
        where it has one, else a width-1 scatter of ones."""
        b, n = self.idx.shape[:2]
        return self.plan.in_degree(b, n, dtype)

    # the network's layout: the cube's on the direct and block routes
    gather_edges = gather
    scatter_edges = scatter_add

    def segment_mean(self, edges: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
        """Network-layout edges -> (b, N, C) cube means by neighbor id over
        the in-degree `counts` (tf.unsorted_segment_mean: empty -> 0)."""
        return self.scatter_edges(edges) / torch.clamp_min(counts, 1.0)[..., None]

    def edges_in(self, edges: torch.Tensor) -> torch.Tensor:
        """Cube edges (b, N, K, C) -> the network's layout."""
        return edges

    def nodes_out(self, h: torch.Tensor) -> torch.Tensor:
        """Network-layout nodes -> the cube (b, N, C)."""
        return h


class _BlockRoute(Route):
    """Kernels F/G over the BlockPlan of CORE blocks (every slot)."""

    graph_plan = None

    def _gather(self, values, idx, plan):
        return blocked.block_gather(values, plan, self.cells, self.window,
                                    fast=values.dtype == torch.bfloat16)

    def _scatter(self, vals, idx, plan):
        return blocked.block_scatter_add(vals, plan, self.cells, self.window,
                                         fast=vals.dtype == torch.bfloat16)

    def counts(self, dtype=torch.float32) -> torch.Tensor:
        return blocked.plan_counts(self.plan, self.cells, self.window,
                                   self.core, dtype=dtype)


class _MaskedRoute(Route):
    """Kernels D/E or H/I over the masked plan; the network's layout is
    block-major."""

    block_major = True
    graph_plan = None

    def gather(self, values):
        return blocked.masked_gather(values, self.plan, self.cells, self.window,
                                     core=self.core, self_slot0=True)

    def scatter_add(self, edges):
        return blocked.masked_scatter_add(edges, self.plan, self.cells,
                                          self.window, core=self.core,
                                          self_slot0=True)

    def counts(self, dtype=torch.float32):
        return blocked.masked_counts(self.plan, self.cells, self.window,
                                     self.core, True, dtype)

    def gather_edges(self, nodes):
        """Cube nodes (b, N, C) -> block-major edges (b, NB, R, K, C)."""
        return blocked.masked_gather_blocks(nodes, self.plan, self.cells,
                                            self.window, core=self.core,
                                            self_slot0=True)

    def scatter_edges(self, edges):
        """Block-major edges (b, NB, R, K, C) -> cube sums (b, N, C)."""
        return blocked.masked_scatter_add_blocks(edges, self.plan, self.cells,
                                                 self.window, core=self.core,
                                                 self_slot0=True)

    def edges_in(self, edges):
        return blocked.edges_cube_to_blocks(edges, self.cells, core=self.core)

    def nodes_out(self, h):
        return blocked.nodes_blocks_to_cube(h, self.cells, core=self.core)

    def to_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, C) cube order -> (B, NB, R, C) block-major."""
        return blocked.cube_to_blocks(x, self.cells, self.core)

    def to_cube(self, xb: torch.Tensor) -> torch.Tensor:
        """(B, NB, R, C) block-major -> (B, N, C) cube order."""
        return blocked.blocks_to_cube(xb, self.cells, self.core)
