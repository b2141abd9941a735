"""The port's velocity model (shiftinv_vel) against the benchmark's plain
reference (benchmark_torch/reference/shiftinv_vel.py), the benchmark's
velocity features against the port's Dataset, and the velocity family's
FLOP count against the JAX package's.

On seeded weights (the benchmark's own, yardstick/weights.py, with T at
the reference's 0.002) at the published widths, 8^3 and 16^3 cubes: the
kNN ids, the forward (b, N, 6), the joint loss and the gradient of every
leaf, T included, on the direct route in f32 and bf16 and on the masked
index route (kernels D/E; the route runs in bf16 only).  f32 is held to
float32 round-off (the port multiplies in another order: the product
before the segment mean where the layer narrows); bf16 to what bf16
compute gives against an f32 reference: 8 significant bits a rounding,
positions up to the box rounded to bf16 before the offsets are taken
(a grid spacing is 4 units, the rounding at the box's top 0.125 units
at 8^3 and 0.25 at 16^3), and six layers of bf16 activations.
"""

import numpy as np
import pytest
import torch

from benchmark_torch.counts import shiftinv_vel as counts
from benchmark_torch.reference import common
from benchmark_torch.reference import shiftinv_vel as ref
from benchmark_torch.yardstick import features, features_vel
from benchmark_torch.yardstick.weights import make_layers
from nbody_tpu.utils.flops import useful_flops_train_step
from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import Dataset, features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.physics.losses import loss_za

torch.set_num_threads(1)

CHANNELS = list(C.GRAPH_VEL_CHANNELS)
WINDOW = 2
# (forward, loss, gradient) bars: relative norm gaps; the gradient's by
# the worst leaf over max(its norm, the median leaf's), as compare.norm_gap
BARS = {"float32": (1e-5, 1e-6, 1e-4), "bfloat16": (5e-2, 1e-4, 8e-2)}
ROUTES = [("direct", "float32"), ("direct", "bfloat16"), ("index", "bfloat16")]


def _inputs(cells, seed=4):
    x = features_vel.features(synthetic_raw_cubes(2, cells, seed=seed, za_rms=0.8))
    return torch.from_numpy(x[..., :9]), torch.from_numpy(x[..., 9:])


def _params():
    layers = make_layers(CHANNELS, ref.NUM_WEIGHTS, ref.NUM_BIASES, 77, "cpu")
    return {"layers": [{"W": l["W"][0], "B": l["B"][0]} for l in layers],
            "T": torch.full((2,), ref.T_INIT)}


def _port(cells, k, route, dtype, params):
    model = build_model(C.ModelConfig(
        family="shiftinv_vel", channels=tuple(CHANNELS), k_neighbors=k,
        dtype=dtype, knn_window=WINDOW,
        mask_dtype="index" if route == "index" else "auto"),
        box=4.0 * cells, device="cpu")
    p = model.params
    with torch.no_grad():
        for i, l in enumerate(params["layers"]):
            p.W[i].copy_(l["W"])
            p.B[i].copy_(l["B"])
        p.T.copy_(params["T"])
    return model


def _gap(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.mark.parametrize("cells,k", [(8, 6), (16, 14)])
@pytest.mark.parametrize("route,dtype", ROUTES)
def test_port_matches_reference(cells, k, route, dtype):
    x_in, target = _inputs(cells)
    params = _params()
    model = _port(cells, k, route, dtype, params)
    pred = model(x_in)
    want_route = "masked" if route == "index" else "direct"
    assert model.impl_record["impl"] == want_route
    loss = loss_za(pred, target)
    loss.backward()
    p = model.params
    got_grads = [w.grad for w in p.W] + [b.grad for b in p.B] + [p.T.grad]

    forward = ref.make_forward({"cells": cells, "k_neighbors": k}, WINDOW)
    leaves = ([l["W"].clone().requires_grad_(True) for l in params["layers"]]
              + [l["B"].clone().requires_grad_(True) for l in params["layers"]]
              + [params["T"].clone().requires_grad_(True)])
    nl = len(params["layers"])
    want = forward({"layers": [{"W": leaves[i], "B": leaves[nl + i]} for i in range(nl)],
                    "T": leaves[-1]}, x_in)
    want_loss = common.loss_za(want, target)
    want_grads = torch.autograd.grad(want_loss, leaves)

    _, _, pos_norm = common.graph_geometry(x_in, 4.0 * cells)
    assert torch.equal(model.knn_fn(x_in).long(),
                       common.lattice_knn(pos_norm, k, cells, WINDOW))
    fwd_bar, loss_bar, grad_bar = BARS[dtype]
    assert pred.shape == want.shape == (2, cells ** 3, 6)
    assert _gap(pred.detach(), want.detach()) < fwd_bar
    want_loss = float(want_loss.detach())
    assert abs(float(loss.detach()) - want_loss) / want_loss < loss_bar
    norms = [float(torch.linalg.vector_norm(g.double())) for g in want_grads]
    med = float(np.median(norms))
    worst = max(float(torch.linalg.vector_norm((g - w).double())) / max(n, med)
                for g, w, n in zip(got_grads, want_grads, norms))
    assert worst < grad_bar
    assert float(torch.linalg.vector_norm(p.T.grad)) > 0


def test_benchmark_velocity_features_equal_dataset():
    """yardstick/features_vel.py's features of the raw cubes, and their
    training split, bit-equal to the port's Dataset(include_velocity=True)."""
    raw = synthetic_raw_cubes(6, 8, seed=7, za_rms=0.6)
    x = features_vel.features(raw)
    assert x.dtype == np.float32 and x.shape == (6, 512, 15)
    np.testing.assert_array_equal(x, features_from_raw(raw, include_velocity=True))
    ds = Dataset(C.DataConfig(num_test=1, num_val=1, cells_per_side=8,
                              include_velocity=True), raw=raw)
    np.testing.assert_array_equal(x[features.train_rows(6, 1, 1)], ds.X_train)


def test_unit_flops_equal_jax_count():
    """counts/shiftinv_vel.unit_flops at 64^3, b4, K 14 and the velocity
    widths is nbody_tpu/utils/flops.py's shiftinv_vel train step."""
    cfg = {"family": "shiftinv_vel", "cells": 64, "k_neighbors": 14,
           "channels": CHANNELS}
    want = useful_flops_train_step("shiftinv_vel", 64 ** 3, 4, 14, CHANNELS)
    assert counts.unit_flops(cfg, {"batch": 4, "driver": "train_scan_vel"}) == want
    assert counts.neighbor_calls(cfg, {"batch": 4}) is None
