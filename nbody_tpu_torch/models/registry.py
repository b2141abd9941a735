"""Model registry (port of nbody_tpu/models/registry.py for the shiftinv
and shiftinv_vel families).

A model takes the standard input batch x_in (b, N, 6) [grid - box/2,
za_disp] -- (b, N, 9) with the velocities for shiftinv_vel -- and returns
the predicted ZA->FastPM residual (b, N, 3), or (b, N, 6), in f32.  The
periodic lattice kNN graph is rebuilt inside every forward, from f32
positions, before anything is cast to the compute dtype.  Mixed precision
is the JAX package's (registry.py:304-322): parameters, and so the Adam
state, stay f32; the forward casts them to the compute dtype and returns
f32 predictions.

Each forward also picks its neighbor route (``_make_masks``) and records
it in ``impl_record``: the masked index route (kernels D/E) for
``mask_dtype="index"`` in bf16, the block route (kernels F/G) for
``neighbor_impl="block"``, else the direct kernels B/C.  Other families
raise NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nbody_tpu_torch import config as C
from nbody_tpu_torch.models import shiftinv
from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.knn import knn_periodic_batch, knn_periodic_lattice_batch

# the exact O(N^2) coverage oracle runs on the device up to this size; above
# it the host searches exactly with a periodic k-d tree (exact_knn_host)
EXACT_KNN_MAX_PARTICLES = 100_000
# the index route's core candidates after --masked_core, in the JAX order
# (registry.py:259); the first that tiles the cube is taken
INDEX_CORES = (blocked.MASKED_CORE, (4, 4, 8), (2, 4, 8), (2, 2, 4), (2, 2, 2))


def _graph_geometry(x_in: torch.Tensor, box: float):
    """Positions (raw units) + ZA displacement from the input batch."""
    q = x_in[..., :3] + box / 2.0
    za = x_in[..., 3:6]
    pos = q + za
    return pos, za


def _make_masks(cfg: C.ModelConfig, cells: int, n: int, idx: torch.Tensor,
                dtype: torch.dtype, record: dict):
    """The neighbor route of one forward -> (masks, lattice), filling
    ``record`` (impl, core, mask_dtype, downgrade) as _make_masks and
    Trainer._log_effective_impl do in JAX (registry.py:218-301).

    masks = per-edge patch positions (block_positions, self slot dropped)
    and lattice = (cells, window, core, True) select the masked index
    route; (None, (cells, window)) the block route; (None, None) the
    direct kernels B/C.  The index kernels select in bf16, so exact-f32
    mode downgrades ``index`` to the direct route and records it."""
    record.update(impl="direct", core=None, mask_dtype=None, downgrade=None)
    if n != cells ** 3:
        return None, None
    if cfg.neighbor_impl == "block":
        record.update(impl="block", core=list(blocked.CORE))
        return None, (cells, cfg.knn_window)
    if cfg.mask_dtype != "index":
        return None, None
    if dtype == torch.float32:
        record.update(downgrade="mask_dtype 'index' in float32: the index "
                                "kernels select in bf16; direct kernels B/C")
        return None, None
    candidates = ([tuple(cfg.masked_core)] if cfg.masked_core else []) + list(INDEX_CORES)
    for core in candidates:
        if all(cells % d == 0 for d in core):
            record.update(impl="masked", core=list(core), mask_dtype="index")
            pos = blocked.block_positions(idx, cells, cfg.knn_window, core=core,
                                          drop_self_slot0=True)
            return pos, (cells, cfg.knn_window, core, True)
    record.update(downgrade=f"no index core tiles a {cells}^3 cube; "
                            "direct kernels B/C")
    return None, None


class ShiftInvModel(nn.Module):
    """The shiftinv and shiftinv_vel families: lattice kNN + 4-op graph
    network.  ``forward`` is the JAX Model.apply (nn.Module.apply has
    another meaning); knn_fn, apply_with_idx and impl_record keep their JAX
    names."""

    def __init__(self, cfg: C.ModelConfig, box: float, device=None):
        super().__init__()
        self.cfg = cfg
        self.velocity = cfg.family == "shiftinv_vel"
        default, c_in = ((C.GRAPH_VEL_CHANNELS, 9) if self.velocity
                         else (C.GRAPH_CHANNELS, 3))
        channels = list(cfg.channels)
        if channels[0] != c_in:
            channels = list(default)
        self.box = box
        self.cells = int(round(box / 4.0))
        self.k = cfg.k_neighbors
        self.window = cfg.knn_window
        self.dtype = getattr(torch, cfg.dtype)
        gen = torch.Generator().manual_seed(cfg.seed)
        init = (shiftinv.init_shiftinv_vel_params if self.velocity
                else shiftinv.init_shiftinv_params)
        self.params = init(gen, channels).to(device)
        self.impl_record: dict = {}

    def knn_fn(self, x_in: torch.Tensor) -> torch.Tensor:
        """x_in (b, N, C) -> idx (b, N, K) int32, searched in f32 on the
        unit torus: pos_norm = mod(pos / box, 1) (registry.py:99-101)."""
        pos, _ = _graph_geometry(x_in, self.box)
        with torch.no_grad():
            pos_norm = torch.remainder(pos / self.box, 1.0)
            return knn_periodic_lattice_batch(pos_norm, self.k, cells=self.cells,
                                              window=self.window)

    def apply_with_idx(self, x_in: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Forward given the graph; casts to the compute dtype AFTER the kNN
        (registry.py:415-423) and returns f32."""
        dt = self.dtype
        pos, za = _graph_geometry(x_in, self.box)
        masks, lattice = _make_masks(self.cfg, self.cells, x_in.shape[-2], idx,
                                     dt, self.impl_record)
        layers = self.params.layers(dt)
        if self.velocity:
            out = shiftinv.shiftinv_vel_model(
                {"layers": layers, "T": self.params.T.to(dt)}, pos.to(dt),
                za.to(dt), x_in[..., 6:9].to(dt), idx, self.box,
                lattice=lattice, masks=masks)
        else:
            out = shiftinv.shiftinv_model(layers, pos.to(dt), za.to(dt), idx,
                                          self.box, lattice=lattice,
                                          masks=masks)
        return out.to(torch.float32)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        return self.apply_with_idx(x_in, self.knn_fn(x_in))


def build_model(cfg: C.ModelConfig, box: float = C.BOX_SIZE,
                device=None) -> ShiftInvModel:
    C.check_model_config(cfg)
    return ShiftInvModel(cfg, box, device)


def exact_knn_host(pos_norm: np.ndarray, k: int) -> np.ndarray:
    """Exact periodic kNN on the host: (b, N, 3) unit-torus positions ->
    (b, N, k) int64 ids, by scipy's cKDTree with boxsize 1.  Stands in
    for the JAX package's sklearn ghost-padding search (registry.py:157-178;
    sklearn is not a dependency of the port); both are exact, so the
    tie-insensitive per-row distance sums agree."""
    from scipy.spatial import cKDTree
    out = []
    for p in np.asarray(pos_norm, np.float64):
        p = np.where(p >= 1.0, 0.0, p)    # f32 mod can round up to 1.0
        _, ids = cKDTree(p, boxsize=1.0).query(p, k=k, workers=-1)
        out.append(np.reshape(ids, (p.shape[0], k)))
    return np.stack(out)


def neighbor_sq_dist_sums(p: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Per-row sum of squared min-image neighbor distances, in f64 (the
    tie-insensitive comparison of registry.py:187-196): p (b, N, 3) on the
    unit torus, idx (b, N, K) -> (b, N)."""
    p = np.asarray(p, np.float64)
    out = np.zeros(idx.shape[:2], np.float64)
    for bi in range(p.shape[0]):
        d = p[bi][idx[bi]] - p[bi][:, None, :]
        d -= np.round(d)
        out[bi] = np.sum(d * d, axis=(1, 2))
    return out


def coverage_violations(cfg: C.ModelConfig, box: float, x_in: torch.Tensor) -> int:
    """Rows whose lattice-window neighbors are farther than their true kNN
    (0 == the graph is provably covered), as registry.py:125-203 counts
    them: the lattice search's per-row sum of squared neighbor distances
    against an exact search's, in f64 on the host, with the same 1e-6 tie
    tolerance.  The exact search is the O(N^2) device search up to
    EXACT_KNN_MAX_PARTICLES and the host k-d tree above.  Call once per
    run, not per step."""
    C.check_family(cfg.family)
    cells = int(round(box / 4.0))
    pos, _ = _graph_geometry(x_in, box)
    n = pos.shape[-2]
    if n != cells ** 3:
        raise ValueError(f"coverage check needs a full cells^3 cube, N={n}")
    k = cfg.k_neighbors
    with torch.no_grad():
        pos_norm = torch.remainder(pos / box, 1.0)
        idx_lat = knn_periodic_lattice_batch(pos_norm, k, cells=cells,
                                             window=cfg.knn_window)
        p = pos_norm.cpu().numpy()
        if n > EXACT_KNN_MAX_PARTICLES:
            idx_ex = exact_knn_host(p, k)
        else:
            idx_ex = knn_periodic_batch(pos_norm, k).cpu().numpy()
    lat = neighbor_sq_dist_sums(p, idx_lat.cpu().numpy())
    return int(np.sum(lat > neighbor_sq_dist_sums(p, idx_ex) + 1e-6))
