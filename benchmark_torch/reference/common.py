"""Plain PyTorch pieces the families' references share: the periodic
lattice kNN, neighbor gathers and segment sums by indexing, the loss,
Adam, and the casts that put a reference in a lower precision.

Nothing here imports the program: the references are written from the
reference's equations (evdcush/N-Body_PointCloudEvolution, graph.py and
nn.py, as the JAX package restates them) in float32 with TF32 off
(``strict_f32``), with no kernel, cache or batching of the port.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import torch

# the largest finite float8 e4m3 value
FP8_MAX = 448.0


def strict_f32():
    """float32 matmuls in float32: TF32 off (on the card a float32
    matmul may otherwise run in TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def f32_within():
    """strict_f32 inside the block only: the flags as they were after it
    (a reference run in set-up leaves the program's settings alone)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    strict_f32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 and back, scaled per tensor so that its
    largest magnitude maps to 448 (the amax scaling of fp8 training): the
    control's storage of every input, weight and activation.  The scale is
    a constant to autograd; the rounding passes the gradient through."""
    scale = (torch.amax(torch.abs(x.detach())) / FP8_MAX).clamp_min(1e-30)
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def lattice_knn(pos_norm: torch.Tensor, k: int, cells: int,
                window: int) -> torch.Tensor:
    """Periodic kNN of grid-ordered cubes on the unit torus: (b, N, 3)
    -> (b, N, k) int64 ids, self at slot 0.  Each particle's candidates
    are the particles of the (2w+1)^3 lattice sites around its own site,
    in lexicographic offset order; the squared min-image distance is
    summed x, y, z in that order; the k nearest are kept with ties to the
    earliest candidate (the reference's search restated on the lattice,
    nbody_tpu/ops/knn.py:173-239)."""
    b, n, _ = pos_norm.shape
    w = min(window, (cells - 1) // 2)
    offs = [(dx, dy, dz) for dx in range(-w, w + 1)
            for dy in range(-w, w + 1) for dz in range(-w, w + 1)]
    grid = pos_norm.reshape(b, cells, cells, cells, 3)
    cands = torch.stack([torch.roll(grid, (-dx, -dy, -dz), dims=(1, 2, 3))
                         .reshape(b, n, 3) for dx, dy, dz in offs], dim=2)
    d = min_image(cands - pos_norm[:, :, None, :], 1.0)
    sq = d * d
    d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
    d2[:, :, offs.index((0, 0, 0))] = -1.0
    sel = torch.sort(d2, dim=-1, stable=True).indices[..., :k]
    m = 2 * w + 1
    site = torch.arange(n, device=pos_norm.device)
    x, y, z = site // (cells * cells), (site // cells) % cells, site % cells
    nx = torch.remainder(x[:, None] + sel // (m * m) - w, cells)
    ny = torch.remainder(y[:, None] + (sel // m) % m - w, cells)
    nz = torch.remainder(z[:, None] + sel % m - w, cells)
    return (nx * cells + ny) * cells + nz


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (b, N, C), idx (b, M, K) -> (b, M, K, C): x[b, idx[b, m, k]]."""
    b = x.shape[0]
    return x[torch.arange(b, device=x.device)[:, None, None], idx]


def segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """vals (b, M, K, C) summed by target idx (b, M, K) -> (b, n, C)."""
    b, c = vals.shape[0], vals.shape[-1]
    flat = (idx + n * torch.arange(b, device=idx.device)[:, None, None]).reshape(-1)
    out = torch.zeros((b * n, c), dtype=vals.dtype, device=vals.device)
    return out.index_add(0, flat, vals.reshape(-1, c)).reshape(b, n, c)


def in_degree(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Edges that point at each particle: (b, N, K) -> (b, N) float32."""
    ones = torch.ones(idx.shape + (1,), dtype=torch.float32, device=idx.device)
    return segment_sum(ones, idx, n)[..., 0]


def loss_za(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over samples and particles of the squared error summed over
    x, y, z (reference loss_ZA, nn.py:151-166)."""
    return torch.mean(torch.sum(torch.square(pred - target), dim=-1))


def graph_geometry(x_in: torch.Tensor, box: float):
    """x_in (b, N, 6) [grid - box/2, ZA displacement] -> (positions, ZA
    displacement, positions on the unit torus)."""
    za = x_in[..., 3:6]
    pos = x_in[..., :3] + box / 2.0 + za
    return pos, za, torch.remainder(pos / box, 1.0)


class Adam:
    """Adam with b1 0.9, b2 0.999, eps 1e-8 and bias correction (the
    reference's tf.train.AdamOptimizer; optax.adam), in float32."""

    def __init__(self, leaves: List[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.leaves, self.lr, self.b1, self.b2, self.eps = leaves, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / bc1 * m / (torch.sqrt(v) / math.sqrt(bc2) + self.eps))


def train_steps(forward: Callable, layers: List[Dict[str, torch.Tensor]],
                batches, lr: float, cast: Callable = identity,
                batch_keep: float = 1.0):
    """Run the reference's train steps from `layers` (float32 [{"W", "B"},
    ...], not modified) over `batches` [(x_in (b, N, 6), target (b, N, 3)),
    ...] -> (losses, first gradients, parameter changes, each step's
    per-cube losses), the leaves in the order W0..W{L-1}, B0..B{L-1}.  A step's gradient is accumulated
    cube by cube (the loss is a mean over cubes), so that one cube's
    activations are held at a time.  ``batch_keep`` < 1 keeps only the
    first share of each batch and takes the mean over it (a planted fault
    for the tests of the comparison)."""
    nl = len(layers)
    leaves = [layers[i]["W"].detach().clone() for i in range(nl)] + \
             [layers[i]["B"].detach().clone() for i in range(nl)]
    start = [p.clone() for p in leaves]
    adam = Adam(leaves, lr)
    losses, first, per_cube = [], None, []
    for x_in, target in batches:
        keep = max(1, int(round(x_in.shape[0] * batch_keep)))
        grads = [torch.zeros_like(p) for p in leaves]
        total = 0.0
        per_cube.append([])
        for j in range(keep):
            params = [p.detach().requires_grad_(True) for p in leaves]
            cur = [{"W": params[i], "B": params[nl + i]} for i in range(nl)]
            loss = loss_za(forward(cur, x_in[j:j + 1], cast),
                           target[j:j + 1]) / keep
            got = torch.autograd.grad(loss, params)
            for acc, g in zip(grads, got):
                acc.add_(g)
            total += float(loss.detach())
            per_cube[-1].append(float(loss.detach()) * keep)
        losses.append(total)
        if first is None:
            first = [g.clone() for g in grads]
        adam.step(grads)
    return losses, first, [p - p0 for p, p0 in zip(leaves, start)], per_cube
