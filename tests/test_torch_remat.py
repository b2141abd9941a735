"""--remat (ModelConfig.remat): every graph layer recomputed in the backward
pass (torch.utils.checkpoint, the port of jax.checkpoint around each
layer).  The recomputed forward runs the same kernels' plain versions on
the same inputs, so the loss and every gradient equal the plain step's
bit for bit, for shiftinv, shiftinv_vel and shiftinv15, in the dense
(cube) network on the direct route and the block-major network on the
masked index route (bf16, as JAX's
tests/test_grad_parity.py::test_index_mode_grads_match_masked_under_remat
runs it).
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import features_from_raw, split_batch
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops.kernels import banded_kernels, block_kernels
from nbody_tpu_torch.physics.losses import loss_za

torch.set_num_threads(1)

CELLS = 8
CHANNELS = {"shiftinv": (3, 16, 3), "shiftinv15": (3, 8, 3),
            "shiftinv_vel": (9, 16, 6)}


def _step(family, remat, **model):
    """Loss and gradients of one forward + backward."""
    vel = family == "shiftinv_vel"
    x = torch.from_numpy(features_from_raw(
        synthetic_raw_cubes(2, CELLS, seed=0), include_velocity=vel))
    x_in, y = split_batch(x, 9 if vel else 6)
    net = build_model(C.ModelConfig(family=family, channels=CHANNELS[family],
                                    k_neighbors=6, knn_window=2, seed=3,
                                    remat=remat, **model),
                      box=4.0 * CELLS, device="cpu")
    loss = loss_za(net(x_in), y)
    loss.backward()
    return loss.detach(), [p.grad for p in net.parameters()], net.impl_record


@pytest.mark.parametrize("family", ["shiftinv", "shiftinv_vel", "shiftinv15"])
@pytest.mark.parametrize("route", ["direct", "index"])
def test_remat_grads_equal_plain(family, route, monkeypatch):
    """Equal bits, and the remat step really recomputes: it gathers more
    often (kernel B's plain version on the direct route, D's on the
    index route)."""
    model = ({"dtype": "float32"} if route == "direct"
             else {"dtype": "bfloat16", "mask_dtype": "index"})
    mod, name = ((banded_kernels, "gather_plain") if route == "direct"
                 else (block_kernels, "select_gather_plain"))
    calls = []
    plain = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: calls.append(1) or plain(*a))
    l0, g0, rec = _step(family, False, **model)
    n0 = len(calls)
    l1, g1, rec1 = _step(family, True, **model)
    assert len(calls) - n0 > n0
    assert rec == rec1 and rec["impl"] == ("direct" if route == "direct"
                                           else "masked")
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert len(g0) == len(g1) and all(g is not None for g in g1)
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(b.float().numpy(), a.float().numpy())
