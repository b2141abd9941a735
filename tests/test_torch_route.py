"""The neighbor route (ops/route.py, models/registry._make_route) against
the code it replaced, frozen in tests/data/route_parent.json.

That file holds what the models computed at commit bfc6dec, before the
route became one object: for shiftinv, shiftinv_vel and shiftinv15 on the
direct, --impl banded, --impl block, --mask_dtype index and --mask_dtype
int8 routes in bf16, and shiftinv on the direct route in f32 (8^3 b2, K 6,
window 2, one CPU thread), the sha256 of the forward's output and of the
parameter gradients of one loss; and for every route choice of
test_torch_mask_route.py (neighbor_impl x mask_dtype x dtype x core, the
f32 downgrade, the int8/int4 fallback under the cap, a cube no core
tiles, a graph not from the lattice search) the impl_record the route
filled and the warnings it raised.  Outputs and gradients must stay bit
for bit, and the records key for key.  ~5 s on one worker
(``--durations``: the slowest case, shiftinv15 on int8, ~0.5 s).
"""

import hashlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import features_from_raw
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models import registry
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.physics.losses import loss_za

torch.set_num_threads(1)

with open(os.path.join(os.path.dirname(__file__), "data",
                       "route_parent.json")) as f:
    PARENT = json.load(f)

CELLS, K = 8, 6
CHANNELS = {"shiftinv": (3, 16, 8, 3), "shiftinv_vel": (9, 16, 8, 6),
            "shiftinv15": (3, 16, 8, 3)}
ROUTES = {"direct": {}, "banded": {"neighbor_impl": "banded"},
          "block": {"neighbor_impl": "block"}, "index": {"mask_dtype": "index"},
          "int8": {"mask_dtype": "int8"}}


def _sha(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _model_cases():
    cases = [(f"{fam}-{r}-bfloat16", fam, r, "bfloat16")
             for fam in CHANNELS for r in ROUTES]
    return cases + [("shiftinv-direct-float32", "shiftinv", "direct", "float32")]


@pytest.mark.parametrize("case,family,route,dtype", _model_cases(),
                         ids=[c[0] for c in _model_cases()])
def test_outputs_and_gradients_bit_equal_to_parent(case, family, route, dtype):
    velocity = family == "shiftinv_vel"
    x = features_from_raw(synthetic_raw_cubes(2, CELLS, seed=5),
                          include_velocity=velocity)
    c = 9 if velocity else 6
    x_in = torch.from_numpy(np.ascontiguousarray(x[..., :c]))
    y = torch.from_numpy(np.ascontiguousarray(x[..., c:]))
    model = build_model(C.ModelConfig(
        family=family, channels=CHANNELS[family], k_neighbors=K, dtype=dtype,
        knn_window=2, seed=7, **ROUTES[route]), box=4.0 * CELLS, device="cpu")
    pred = model(x_in)
    loss = loss_za(pred, y)
    loss.backward()
    want = PARENT["models"][case]
    assert model.impl_record == want["record"]
    assert float(loss.detach()) == want["loss"]
    assert _sha([pred]) == want["out"]
    assert _sha([p.grad for p in model.parameters()]) == want["grads"]


def _record_cases():
    cases = {}
    for fam in ("shiftinv", "shiftinv15"):
        for md in ("auto", "index", "int8", "int4"):
            for dt in ("bfloat16", "float32"):
                for core in (None, (2, 2, 2)):
                    name = "".join(map(str, core)) if core else "default"
                    cases[f"{fam}-masked-{md}-{dt}-core{name}"] = dict(
                        family=fam, mask_dtype=md, dtype=dt, masked_core=core)
    for impl in ("block", "banded"):
        for dt in ("bfloat16", "float32"):
            cases[f"shiftinv-{impl}-{dt}"] = dict(neighbor_impl=impl, dtype=dt)
    cases["shiftinv-block-cells6"] = dict(neighbor_impl="block", cells=6)
    cases["shiftinv-masked-index-cells6"] = dict(mask_dtype="index", cells=6)
    cases["shiftinv-masked-index-exact"] = dict(mask_dtype="index",
                                                knn_method="exact")
    for md in ("int8", "int4"):
        cases[f"shiftinv-masked-{md}-cap1000"] = dict(mask_dtype=md, cap=1000)
        cases[f"shiftinv-masked-{md}-cap4MiB"] = dict(mask_dtype=md,
                                                      cap=4 * 2 ** 20)
    return cases


RECORD_CASES = _record_cases()


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_route_record_equals_parent(case, monkeypatch):
    """_make_route(...).record() is the dict the route choice filled
    before, with the same warnings."""
    spec = dict(RECORD_CASES[case])
    cells = spec.pop("cells", CELLS)
    cap = spec.pop("cap", None)
    dtype = getattr(torch, spec.pop("dtype", "bfloat16"))
    if cap:
        monkeypatch.setattr(registry, "MASKED_BYTES_CAP", cap)
    idx = torch.zeros((2, cells ** 3, K), dtype=torch.int32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        route = registry._make_route(C.ModelConfig(k_neighbors=K, knn_window=2,
                                                   **spec),
                                     cells, cells ** 3, idx, dtype)
    want = PARENT["records"][case]
    assert route.record() == want["record"]
    assert [str(w.message) for w in caught] == want["warnings"]
