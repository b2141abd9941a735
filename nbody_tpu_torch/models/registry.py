"""Model registry (port of nbody_tpu/models/registry.py for every family:
set, shiftinv, shiftinv15, attn and shiftinv_vel).

A model takes the standard input batch x_in (b, N, 6) [grid - box/2,
za_disp] -- (b, N, 9) with the velocities for shiftinv_vel -- and returns
the predicted ZA->FastPM residual (b, N, 3), or (b, N, 6), in f32.
``forward`` is the JAX Model.apply (nn.Module.apply has another meaning)
and ``eval_fn`` its eval-mode forward: attn's ``apply_eval`` (frozen
batch-norm statistics), the same forward for the others; neither follows
the module's train() / eval() flag.  The graph families rebuild the
periodic kNN graph inside every forward, from f32 positions, before
anything is cast to the compute dtype (``_make_knn``: kernel A's lattice
search on a full cells^3 cube with knn_method "lattice", else the banded
or exact pairwise search).  Mixed precision is the JAX package's
(registry.py:304-322): parameters, and so the Adam state, stay f32; the
forward casts them and the input to the compute dtype and returns f32
predictions.

Each forward also picks its neighbor route (``_make_route``, an
ops/route.Route) and records it in ``impl_record``: the masked index
route (kernels D/E) for ``mask_dtype="index"`` and the integer-mask route
(kernels H/I) for ``mask_dtype="int8"|"int4"``, both in bf16; the block
route (kernels F/G) for ``neighbor_impl="block"``; the direct kernels B/C
for ``neighbor_impl="banded"`` (recorded as "banded") and otherwise.  Only
the lattice search on a full cube takes the block and masked routes, as
in JAX.  The set and attn families use no neighbor op.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.models import attn, set_net, shiftinv, shiftinv15
from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.banded import band_violations, default_band
from nbody_tpu_torch.ops.knn import knn_periodic_batch, knn_periodic_lattice_batch
from nbody_tpu_torch.ops.route import MASKED_KINDS, Route

# the exact O(N^2) coverage oracle runs on the device up to this size; above
# it the host searches exactly with a periodic k-d tree (exact_knn_host)
EXACT_KNN_MAX_PARTICLES = 100_000
# the masked routes' core candidates after --masked_core, in the JAX order
# (registry.py:259); the first that tiles the cube (and, for int8/int4,
# whose masks fit MASKED_BYTES_CAP) is taken
MASKED_CORES = (blocked.MASKED_CORE, (4, 4, 8), (2, 4, 8), (2, 2, 4), (2, 2, 2))
# the 15-op family puts the biggest core first (registry.py:260-264)
MASKED_CORE_15 = (8, 8, 8)
# the int8/int4 mask array's cap, estimated as JAX does at one byte per
# (edge, patch site) for both encodings (jnp.int4's itemsize is 1), so that
# the same core is chosen; the packed int4 array holds half of it
MASKED_BYTES_CAP = 8 * 1024 ** 3


def _graph_geometry(x_in: torch.Tensor, box: float):
    """Positions (raw units) + ZA displacement from the input batch."""
    q = x_in[..., :3] + box / 2.0
    za = x_in[..., 3:6]
    pos = q + za
    return pos, za


def _resolve_band(cfg: C.ModelConfig, box: float):
    """cfg.band, with "auto" derived from the cube geometry
    (registry.py:55-60)."""
    if cfg.band == "auto":
        return default_band(int(round(box / 4.0)), window=cfg.knn_window)
    return cfg.band


def _uses_lattice(cfg: C.ModelConfig, n: int, cells: int) -> bool:
    """Whether the graph comes from the lattice search (kernel A)."""
    return cfg.knn_method == "lattice" and n == cells ** 3


def _effective_band(cfg: C.ModelConfig, band, n: int, cells: int):
    """The band the search that produced idx guarantees
    (registry.py:63-74): the lattice search on a full cube or an
    explicitly banded search; None ("no band") for the exact search and
    the lattice method's exact fallback on other point sets."""
    if cfg.knn_method == "banded" or _uses_lattice(cfg, n, cells):
        return band
    return None


def _make_knn(cfg: C.ModelConfig, box: float):
    """The kNN search of a graph model (registry.py:77-122): unit-torus
    positions (b, N, 3) -> idx (b, N, K) int32.  Kernel A's lattice search
    on a full cells^3 cube with knn_method "lattice"; the banded search
    with knn_method "banded"; else (knn_method "exact", or another point
    set) the exact search, since the index band cannot be assumed."""
    k, cells = cfg.k_neighbors, int(round(box / 4.0))
    band = _resolve_band(cfg, box)

    def knn(pos_norm: torch.Tensor) -> torch.Tensor:
        if _uses_lattice(cfg, pos_norm.shape[-2], cells):
            return knn_periodic_lattice_batch(pos_norm, k, cells=cells,
                                              window=cfg.knn_window)
        if cfg.knn_method == "banded":
            return knn_periodic_batch(pos_norm, k, band=band)
        return knn_periodic_batch(pos_norm, k)

    return knn


def _make_route(cfg: C.ModelConfig, cells: int, n: int, idx: torch.Tensor,
                dtype: torch.dtype) -> Route:
    """The neighbor route of one forward, its plan or masks built here
    once, as _make_masks and Trainer._log_effective_impl pick and record
    it in JAX (registry.py:218-301; ``Route.record``).

    The masked index route (``mask_dtype="index"``: the BlockPlan of
    per-edge patch positions) and the int8 / int4 route (one-hot masks),
    self slot dropped; the block route for ``neighbor_impl="block"``; the
    direct kernels B/C, which ``neighbor_impl="banded"`` (recorded as
    "banded") and every graph not from the lattice search take.  The mask
    kernels select in bf16, so exact-f32 mode downgrades ``index``,
    ``int8`` and ``int4`` to the direct route and records it.  The
    candidate cores follow --masked_core, with (8, 8, 8) first for
    shiftinv15; int8/int4 take the first candidate core whose masks fit
    MASKED_BYTES_CAP and fall back to the block route, with a warning,
    when none does."""
    b, k = idx.shape[0], idx.shape[-1]
    if cfg.neighbor_impl == "banded":
        return Route.direct(idx, "banded")
    if not _uses_lattice(cfg, n, cells):
        return Route.direct(idx)
    if cfg.neighbor_impl == "block":
        return Route.block(idx, cells, cfg.knn_window)
    req = cfg.mask_dtype
    if req not in MASKED_KINDS:
        return Route.direct(idx)
    if dtype == torch.float32:
        return Route.direct(idx, downgrade=f"mask_dtype {req!r} in float32: "
                            "the mask kernels select in bf16; direct kernels B/C")
    candidates = ([tuple(cfg.masked_core)] if cfg.masked_core else []) + (
        [MASKED_CORE_15] if cfg.family == "shiftinv15" else []) + list(MASKED_CORES)
    for core in candidates:
        if any(cells % d for d in core):
            continue
        if req == "index" or b * n * (k - 1) * blocked.patch_size(
                cells, cfg.knn_window, core) <= MASKED_BYTES_CAP:
            return Route.masked(req, idx, cells, cfg.knn_window, core)
    if req == "index":
        return Route.direct(idx, downgrade=f"no index core tiles a {cells}^3 "
                            "cube; direct kernels B/C")
    why = (f"no candidate core's {req} masks fit the "
           f"{MASKED_BYTES_CAP / 2 ** 30:.1f} GiB cap at this size")
    warnings.warn(f"mask_dtype={req!r}: {why}; falling back to the block "
                  "kernels", stacklevel=2)
    return Route.block(idx, cells, cfg.knn_window,
                       downgrade=f"{why}; block kernels F/G")


def resolve_device(device=None) -> torch.device:
    """The device a model (and the CLI's --platform) runs on: the card
    unless the caller names another; a card that is not there is
    refused."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (use the CPU -- "
                           "device 'cpu', --platform cpu -- for the plain "
                           "versions)")
    return device


class _Model(nn.Module):
    """What every family shares: its config, box, compute dtype and
    ``impl_record`` (the neighbor route a forward took; empty for the
    families without neighbor ops), and ``eval_fn``."""

    def __init__(self, cfg: C.ModelConfig, box: float):
        super().__init__()
        self.cfg = cfg
        self.box = box
        self.dtype = getattr(torch, cfg.dtype)
        self.impl_record: dict = {}

    @property
    def eval_fn(self):
        """The eval-mode forward (JAX Model.eval_fn)."""
        return self.forward


def _channels(cfg: C.ModelConfig, c_in: int, default) -> list:
    """cfg.channels, or `default` when they do not start at c_in
    (registry.py:343, :464)."""
    channels = list(cfg.channels)
    return channels if channels[0] == c_in else list(default)


class SetModel(_Model):
    """The set family (models/set_net.py).  Parameters on `device`, the
    card unless named."""

    def __init__(self, cfg: C.ModelConfig, box: float, device=None):
        super().__init__(cfg, box)
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = set_net.init_set_params(
            gen, _channels(cfg, 6, C.CHANNELS)).to(device)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return set_net.set_network(self.params.layers(dt),
                                   x_in.to(dt)).to(torch.float32)


class AttnModel(_Model):
    """The attn family (models/attn.py): ``forward`` with batch
    statistics (JAX apply), ``apply_eval`` with the frozen (0, 1)
    statistics (JAX apply_eval, the trainer's eval_fn).  Parameters on
    `device`, the card unless named."""

    def __init__(self, cfg: C.ModelConfig, box: float, device=None):
        super().__init__(cfg, box)
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = attn.init_attn_params(
            gen, _channels(cfg, 6, C.ATTN_CHANNELS)).to(device)

    def _attn(self, x_in: torch.Tensor, train_mode: bool) -> torch.Tensor:
        dt = self.dtype
        return attn.attn_network(
            self.params.layers(dt), x_in.to(dt),
            batch_coupled_gate=self.cfg.batch_coupled_gate,
            train_mode=train_mode).to(torch.float32)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        return self._attn(x_in, True)

    def apply_eval(self, x_in: torch.Tensor) -> torch.Tensor:
        return self._attn(x_in, False)

    @property
    def eval_fn(self):
        return self.apply_eval


class ShiftInvModel(_Model):
    """The shiftinv and shiftinv_vel families: kNN graph + 4-op graph
    network.  knn_fn, apply_with_idx and impl_record keep their JAX
    names; forward marks ``knn`` after the search into an open step
    timeline (tracing.py).  The parameters live on `device`, the card
    unless named."""

    def __init__(self, cfg: C.ModelConfig, box: float, device=None):
        super().__init__(cfg, box)
        device = resolve_device(device)
        self.cells = int(round(box / 4.0))
        self.k = cfg.k_neighbors
        self.window = cfg.knn_window
        self.velocity = cfg.family == "shiftinv_vel"
        self._knn = _make_knn(cfg, box)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = self._init_params(gen).to(device)

    def _init_params(self, gen: torch.Generator):
        if self.velocity:
            return shiftinv.init_shiftinv_vel_params(
                gen, _channels(self.cfg, 9, C.GRAPH_VEL_CHANNELS))
        return shiftinv.init_shiftinv_params(
            gen, _channels(self.cfg, 3, C.GRAPH_CHANNELS))

    def knn_fn(self, x_in: torch.Tensor) -> torch.Tensor:
        """x_in (b, N, C) -> idx (b, N, K) int32, searched in f32 on the
        unit torus: pos_norm = mod(pos / box, 1) (registry.py:99-101)."""
        pos, _ = _graph_geometry(x_in, self.box)
        with torch.no_grad():
            return self._knn(torch.remainder(pos / self.box, 1.0))

    def apply_with_idx(self, x_in: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Forward given the graph; casts to the compute dtype AFTER the kNN
        (registry.py:415-423) and returns f32."""
        dt = self.dtype
        pos, za = _graph_geometry(x_in, self.box)
        route = _make_route(self.cfg, self.cells, x_in.shape[-2], idx, dt)
        self.impl_record = route.record()
        return self._model(x_in, pos.to(dt), za.to(dt),
                           route).to(torch.float32)

    def _model(self, x_in, pos, za, route) -> torch.Tensor:
        dt, remat = self.dtype, self.cfg.remat
        layers = self.params.layers(dt)
        if self.velocity:
            return shiftinv.shiftinv_vel_model(
                {"layers": layers, "T": self.params.T.to(dt)}, pos, za,
                x_in[..., 6:9].to(dt), route, self.box, remat=remat)
        return shiftinv.shiftinv_model(layers, pos, za, route, self.box,
                                       remat=remat)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        idx = self.knn_fn(x_in)
        tracing.mark("knn")
        return self.apply_with_idx(x_in, idx)


class ShiftInv15Model(ShiftInvModel):
    """The shiftinv15 family: kNN graph, its block-structured symmetrized
    graph and the 15-op network (models/shiftinv15.py), with the same
    knn_fn, apply_with_idx and impl_record as ShiftInvModel."""

    def _init_params(self, gen: torch.Generator):
        return shiftinv15.init_shiftinv15_params(
            gen, _channels(self.cfg, 3, C.GRAPH_CHANNELS))

    def _model(self, x_in, pos, za, route) -> torch.Tensor:
        return shiftinv15.shiftinv15_model(
            self.params.layers(self.dtype), pos, za, route, self.box,
            remat=self.cfg.remat)


MODEL_CLASSES = {"set": SetModel, "attn": AttnModel,
                 "shiftinv": ShiftInvModel, "shiftinv_vel": ShiftInvModel,
                 "shiftinv15": ShiftInv15Model}


def build_model(cfg: C.ModelConfig, box: float = C.BOX_SIZE,
                device=None) -> _Model:
    """The family's model on `device` (the card unless named)."""
    C.check_model_config(cfg)
    return MODEL_CLASSES[cfg.family](cfg, box, device)


def exact_knn_host(pos_norm: np.ndarray, k: int) -> np.ndarray:
    """Exact periodic kNN on the host: (b, N, 3) unit-torus positions ->
    (b, N, k) int64 ids, by scipy's cKDTree with boxsize 1.  Stands in
    for the JAX package's sklearn ghost-padding search (registry.py:157-178;
    sklearn is not a dependency of the port); both are exact, so the
    tie-insensitive per-row distance sums agree.  The span
    ``coverage.host_knn`` covers the search and ``coverage.host_rows``
    counts its b x N rows (tracing.py)."""
    from scipy.spatial import cKDTree
    out = []
    with tracing.span("coverage.host_knn"):
        for p in np.asarray(pos_norm, np.float64):
            p = np.where(p >= 1.0, 0.0, p)    # f32 mod can round up to 1.0
            _, ids = cKDTree(p, boxsize=1.0).query(p, k=k, workers=-1)
            out.append(np.reshape(ids, (p.shape[0], k)))
            tracing.count("coverage.host_rows", p.shape[0])
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
    """Graph edges the configured neighbor pipeline could silently drop on
    this batch (0 == the graph is provably covered), per knn_method as
    registry.py:125-209 counts them:
      lattice on a full cube -- rows whose lattice-window neighbors are
        farther than their true kNN: the per-row sums of squared neighbor
        distances against an exact search's, in f64 on the host, with the
        same 1e-6 tie tolerance;
      banded -- links of the exact search outside the band
        (ops/banded.band_violations);
      exact, and the lattice method's exact fallback on other point sets
        -- 0 by construction.
    The exact search is the O(N^2) device search up to
    EXACT_KNN_MAX_PARTICLES and the host k-d tree above.  0 for the
    families without a graph (set, attn).  Call once per run, not per
    step."""
    C.check_family(cfg.family)
    if cfg.family in C.GRAPHLESS_FAMILIES:
        return 0
    cells = int(round(box / 4.0))
    pos, _ = _graph_geometry(x_in, box)
    n = pos.shape[-2]
    k = cfg.k_neighbors
    with torch.no_grad():
        pos_norm = torch.remainder(pos / box, 1.0)
        p = pos_norm.cpu().numpy()

        def exact_knn():
            if n > EXACT_KNN_MAX_PARTICLES:
                return exact_knn_host(p, k)
            return knn_periodic_batch(pos_norm, k).cpu().numpy()

        if _uses_lattice(cfg, n, cells):
            idx_lat = knn_periodic_lattice_batch(pos_norm, k, cells=cells,
                                                 window=cfg.knn_window)
            lat = neighbor_sq_dist_sums(p, idx_lat.cpu().numpy())
            return int(np.sum(lat > neighbor_sq_dist_sums(p, exact_knn()) + 1e-6))
        band = _effective_band(cfg, _resolve_band(cfg, box), n, cells)
        if band is None:
            return 0
        return int(band_violations(torch.as_tensor(exact_knn()), band))
