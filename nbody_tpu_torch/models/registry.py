"""Model registry (port of nbody_tpu/models/registry.py for the shiftinv
family).

A model takes the standard input batch x_in (b, N, 6) [grid - box/2,
za_disp] and returns the predicted ZA->FastPM residual (b, N, 3) in f32.
The periodic lattice kNN graph is rebuilt inside every forward, from f32
positions, before anything is cast to the compute dtype.  Mixed precision
is the JAX package's (registry.py:304-322): parameters, and so the Adam
state, stay f32; the forward casts them to the compute dtype and returns
f32 predictions.  Other families raise NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nbody_tpu_torch import config as C
from nbody_tpu_torch.models import shiftinv
from nbody_tpu_torch.ops.knn import knn_periodic_batch, knn_periodic_lattice_batch

# the exact O(N^2) coverage oracle runs on the device up to this size; the
# JAX package switches to a host sklearn search above it (not ported)
EXACT_KNN_MAX_PARTICLES = 100_000


def _graph_geometry(x_in: torch.Tensor, box: float):
    """Positions (raw units) + ZA displacement from the input batch."""
    q = x_in[..., :3] + box / 2.0
    za = x_in[..., 3:6]
    pos = q + za
    return pos, za


class ShiftInvModel(nn.Module):
    """The shiftinv family: lattice kNN + 4-op graph network.  ``forward``
    is the JAX Model.apply (nn.Module.apply has another meaning); knn_fn
    and apply_with_idx keep their JAX names."""

    def __init__(self, cfg: C.ModelConfig, box: float, device=None):
        super().__init__()
        channels = list(cfg.channels)
        if channels[0] != 3:
            channels = list(C.GRAPH_CHANNELS)
        self.box = box
        self.cells = int(round(box / 4.0))
        self.k = cfg.k_neighbors
        self.window = cfg.knn_window
        self.dtype = getattr(torch, cfg.dtype)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = shiftinv.init_shiftinv_params(gen, channels).to(device)

    def knn_fn(self, x_in: torch.Tensor) -> torch.Tensor:
        """x_in (b, N, 6) -> idx (b, N, K) int32, searched in f32 on the
        unit torus: pos_norm = mod(pos / box, 1) (registry.py:99-101)."""
        pos, _ = _graph_geometry(x_in, self.box)
        with torch.no_grad():
            pos_norm = torch.remainder(pos / self.box, 1.0)
            return knn_periodic_lattice_batch(pos_norm, self.k, cells=self.cells,
                                              window=self.window)

    def apply_with_idx(self, x_in: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Forward given the graph; casts to the compute dtype AFTER the kNN
        (registry.py:415-423) and returns f32."""
        pos, za = _graph_geometry(x_in, self.box)
        out = shiftinv.shiftinv_model(
            self.params.layers(self.dtype), pos.to(self.dtype),
            za.to(self.dtype), idx, self.box)
        return out.to(torch.float32)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        return self.apply_with_idx(x_in, self.knn_fn(x_in))


def build_model(cfg: C.ModelConfig, box: float = C.BOX_SIZE,
                device=None) -> ShiftInvModel:
    C.check_family(cfg.family)
    if cfg.dtype not in C.DTYPES:
        raise ValueError(f"dtype must be one of {C.DTYPES}, got {cfg.dtype!r}")
    return ShiftInvModel(cfg, box, device)


def coverage_violations(cfg: C.ModelConfig, box: float, x_in: torch.Tensor) -> int:
    """Rows whose lattice-window neighbors are farther than their true kNN
    (0 == the graph is provably covered), as registry.py:125-203 counts
    them: the lattice search's per-row sum of squared neighbor distances
    against the exact O(N^2) search's, in f64 on the host, with the same
    1e-6 tie tolerance.  Call once per run, not per step."""
    C.check_family(cfg.family)
    cells = int(round(box / 4.0))
    pos, _ = _graph_geometry(x_in, box)
    n = pos.shape[-2]
    if n != cells ** 3:
        raise ValueError(f"coverage check needs a full cells^3 cube, N={n}")
    if n > EXACT_KNN_MAX_PARTICLES:
        raise NotImplementedError(
            "the host sklearn coverage search above "
            f"{EXACT_KNN_MAX_PARTICLES} particles is not ported (ROADMAP.md)")
    k = cfg.k_neighbors
    with torch.no_grad():
        pos_norm = torch.remainder(pos / box, 1.0)
        idx_lat = knn_periodic_lattice_batch(pos_norm, k, cells=cells,
                                             window=cfg.knn_window)
        idx_ex = knn_periodic_batch(pos_norm, k)
    p = pos_norm.cpu().numpy().astype(np.float64)

    def ksum(idx: torch.Tensor) -> np.ndarray:
        idx_np = idx.cpu().numpy()
        out = np.zeros(idx_np.shape[:2], np.float64)
        for bi in range(p.shape[0]):
            d = p[bi][idx_np[bi]] - p[bi][:, None, :]
            d -= np.round(d)
            out[bi] = np.sum(d * d, axis=(1, 2))
        return out

    return int(np.sum(ksum(idx_lat) > ksum(idx_ex) + 1e-6))
