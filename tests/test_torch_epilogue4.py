"""The 4-op layer's fused epilogue (ops/kernels/epilogue4): its plain twin
against the chain it replaces, its autograd Function against autograd of
that chain, the kernel's operand check, and both network forms of
models/shiftinv.py against the layer code before the fusion (the chain
h1 + h2 + h3 + h4 + bias, then the activation), with --remat and with an
activation other than relu.  On the CPU every wrapper takes its twin; the
kernels themselves run in chip_smoke.py (phase 19).
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.data.dataset import features_from_raw, split_batch
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models import registry
from nbody_tpu_torch.models import shiftinv as ts
from nbody_tpu_torch.models.base import remat_layer
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.banded import (neighbor_counts, neighbor_gather,
                                        neighbor_segment_mean, route_plan)
from nbody_tpu_torch.ops.kernels import epilogue4 as E4

torch.set_num_threads(1)

CELLS = 8
K = 6
CHANNELS = (3, 16, 8, 3)     # q >= C, q < C (h1 a strided slice), the last


def _terms(shape, dt, seed=0, strided=False):
    """h1, h2 (b, *rows, K, q), h3 (b, *rows, q), h4 (b, q), bias (q,);
    h1 the slice [..., :q] of a (.., 2q) product where `strided`."""
    gen = torch.Generator().manual_seed(seed)
    b, q = shape[0], shape[-1]

    def rnd(*s):
        return torch.randn(*s, generator=gen, dtype=torch.float64).to(dt)

    h1 = rnd(*shape[:-1], 2 * q)[..., :q] if strided else rnd(*shape)
    return h1, rnd(*shape), rnd(*shape[:-2], q), rnd(b, q), rnd(q)


def _chain(h1, h2, h3, h4, bias, relu):
    """The layer's chain as models/shiftinv.py wrote it before the fusion
    (the cube form's broadcasts; the block-major form's are the same with
    one axis more)."""
    view = (h4.shape[0],) + (1,) * (h1.dim() - 2) + (h4.shape[-1],)
    out = h1 + h2 + h3[..., None, :] + h4.reshape(view) + bias
    return torch.relu(out) if relu else out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 5, 3, 8), (2, 3, 4, 3, 6)])
def test_twin_is_the_chain(dtype, relu, shape):
    """The twin, and the Function's forward, equal the chain bit for bit,
    on the cube form's (b, N, K, q) and the block-major (b, NB, R, K, q)."""
    terms = _terms(shape, dtype, seed=len(shape) + relu)
    want = _chain(*terms, relu)
    for got in (E4.epilogue4_plain(*terms, relu), E4.epilogue4(*terms, relu=relu)):
        assert got.dtype == dtype and got.shape == shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 3, 8), (2, 3, 4, 3, 6)])
def test_strided_h1(dtype, shape):
    """h1 as the slice h12[..., :q] of the q < C branch: the kernel reads
    it in place at row stride 2q (_row_stride), and the result is the
    chain's."""
    terms = _terms(shape, dtype, seed=5, strided=True)
    h1 = terms[0]
    assert not h1.is_contiguous() and E4._row_stride(h1) == 2 * shape[-1]
    assert E4._row_stride(h1.contiguous()) == shape[-1]
    assert E4._row_stride(h1.transpose(1, 2)) is None
    assert torch.equal(E4.epilogue4(*terms, relu=True), _chain(*terms, True))


def test_vec_takes_widest_aligned_access():
    """16 bytes where the width, the row stride and every buffer allow:
    8 bf16 or 4 f32; q 6 bf16 takes 2, q 3 one; an odd stride or an
    offset buffer narrows it."""
    bf, f32 = torch.zeros(64, dtype=torch.bfloat16), torch.zeros(64)
    assert E4._vec(32, 64, bf) == 8 and E4._vec(32, 64, f32) == 4
    assert E4._vec(6, 12, bf) == 2 and E4._vec(3, 6, bf) == 1
    assert E4._vec(16, 18, bf) == 2 and E4._vec(16, 16, bf, bf[1:]) == 1


def test_narrow_rows_take_a_thread_each():
    """Rows of 32 bytes or less (q 16, 6, 3 in bf16; q 8 and 3 in f32) take
    the forward's thread-a-row kernel; wider rows a thread group a node."""
    assert all(E4._narrow(q, 2) for q in (16, 6, 3))
    assert all(E4._narrow(q, 4) for q in (8, 3))
    assert not E4._narrow(32, 2) and not E4._narrow(16, 4)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,strided", [((2, 5, 3, 4), False),
                                           ((2, 5, 3, 4), True),
                                           ((2, 2, 3, 3, 3), False)])
def test_function_backward_equals_autograd_f64(relu, shape, strided):
    """The Function's gradients of every operand against autograd of the
    chain in float64, and gradcheck of the Function."""
    terms = [x.requires_grad_() for x in _terms(shape, torch.float64, seed=9,
                                                strided=strided)]
    if strided:
        terms[0] = terms[0].detach().requires_grad_()
    gen = torch.Generator().manual_seed(1)
    grad = torch.randn(shape, generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(E4.Epilogue4.apply(*terms, relu), terms, grad)
    want = torch.autograd.grad(_chain(*terms, relu), terms, grad)
    for g, w, x in zip(got, want, terms):
        assert g.shape == x.shape and g.dtype == x.dtype
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda *xs: E4.Epilogue4.apply(*xs, relu), terms, eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_twin_sums_in_f32(dtype):
    """The backward twin: relu's mask where y <= 0, the K-sum, the sample
    and the batch sums in f32, each result in its operand's dtype."""
    h1, h2, h3, h4, bias = _terms((2, 5, 3, 8), dtype, seed=2)
    y = _chain(h1, h2, h3, h4, bias, True)
    grad = torch.randn(y.shape, generator=torch.Generator().manual_seed(4)).to(dtype)
    g1, g2, d3, d4, db = E4.epilogue4_backward_plain(
        grad, y, (dtype,) * 5)
    g = torch.where(y > 0, grad, torch.zeros_like(grad))
    assert torch.equal(g1, g) and torch.equal(g2, g)
    assert torch.equal(d3, g.float().sum(2).to(dtype))
    assert torch.equal(d4, g.float().sum(2).sum(1).to(dtype))
    assert torch.equal(db, g.float().sum(2).sum(1).sum(0).to(dtype))
    assert (d3.dtype, d4.dtype, db.dtype) == (dtype,) * 3


# ------------------------------------------ the layer code before the fusion

def _parent_layer(h, idx, layer_params, is_last=False, counts=None,
                  lattice=None, masks=None, plan=None):
    w, bias = layer_params["W"], layer_params["B"][0]
    c_in, q = w.shape[1], w.shape[2]
    if q < c_in:
        h12 = torch.matmul(h, torch.cat([w[0], w[1]], dim=1))
        h1, hw = h12[..., :q], h12[..., q:]
        h2 = neighbor_gather(neighbor_segment_mean(hw, idx, counts, lattice,
                                                   masks, plan),
                             idx, lattice, masks, plan)
    else:
        h1 = torch.matmul(h, w[0])
        pooled_rows = neighbor_segment_mean(h, idx, counts, lattice, masks, plan)
        h2 = torch.matmul(neighbor_gather(pooled_rows, idx, lattice, masks,
                                          plan), w[1])
    pooled_cols = torch.mean(h, dim=2)
    h3 = torch.matmul(pooled_cols, w[2])[:, :, None, :]
    h4 = torch.matmul(torch.mean(pooled_cols, dim=1), w[3])[:, None, None, :]
    h_out = h1 + h2 + h3 + h4 + bias
    return torch.mean(h_out, dim=2) if is_last else h_out


def _parent_network(params, edges, idx, activation=torch.relu, lattice=None,
                    masks=None, plan=None, remat=False):
    h = edges
    if plan is None:
        plan = route_plan(idx, lattice, masks)
    counts = neighbor_counts(idx, edges.dtype, lattice, masks, plan)
    layer = remat_layer(_parent_layer, remat)
    for i, layer_params in enumerate(params):
        is_last = i == len(params) - 1
        h = layer(h, idx, layer_params, is_last=is_last, counts=counts,
                  lattice=lattice, masks=masks, plan=plan)
        if not is_last:
            h = activation(h)
    return h


def _parent_layer_blocks(hB, layer_params, masks, cells, window, counts,
                         is_last, core, self_free):
    w, bias = layer_params["W"], layer_params["B"][0]
    c_in, q = w.shape[1], w.shape[2]

    def seg_mean(e):
        s = blocked.masked_scatter_add_blocks(e, masks, cells, window,
                                              core=core, self_slot0=self_free)
        return s / torch.clamp_min(counts, 1.0)[..., None]

    def gather(x):
        return blocked.masked_gather_blocks(x, masks, cells, window, core=core,
                                            self_slot0=self_free)

    if q < c_in:
        h12 = torch.matmul(hB, torch.cat([w[0], w[1]], dim=1))
        h1, h2 = h12[..., :q], gather(seg_mean(h12[..., q:]))
    else:
        h1 = torch.matmul(hB, w[0])
        h2 = torch.matmul(gather(seg_mean(hB)), w[1])
    pooled_cols = torch.mean(hB, dim=3)
    h3 = torch.matmul(pooled_cols, w[2])[:, :, :, None, :]
    h4 = torch.matmul(torch.mean(pooled_cols, dim=(1, 2)),
                      w[3])[:, None, None, None, :]
    h_out = h1 + h2 + h3 + h4 + bias
    return torch.mean(h_out, dim=3) if is_last else h_out


def _parent_network_blocks(params, edges, masks, lattice, activation,
                           remat=False):
    cells, window = lattice[0], lattice[1]
    core = blocked.lattice_core(lattice)
    self_free = blocked.lattice_self_free(lattice)
    hB = blocked.edges_cube_to_blocks(edges, cells, core=core)
    counts = blocked.masked_counts(masks, cells, window, core, self_free,
                                   edges.dtype)
    layer = remat_layer(_parent_layer_blocks, remat)
    for i, layer_params in enumerate(params):
        is_last = i == len(params) - 1
        hB = layer(hB, layer_params, masks, cells, window, counts, is_last,
                   core, self_free)
        if not is_last:
            hB = activation(hB)
    return blocked.nodes_blocks_to_cube(hB, cells, core=core)


def _route(form):
    """The model flags of a network form: the block-major form on the
    masked index route, the cube form on the direct one."""
    return {"mask_dtype": "index"} if form == "block" else {}


def _forward(model, x_in, activation):
    """The model's forward (registry.ShiftInvModel.apply_with_idx) with the
    network's activation given."""
    dt = model.dtype
    idx = model.knn_fn(x_in)
    pos, za = registry._graph_geometry(x_in, model.box)
    masks, lattice = registry._make_masks(model.cfg, model.cells, x_in.shape[-2],
                                          idx, dt, model.impl_record)
    return ts.shiftinv_model(model.params.layers(dt), pos.to(dt), za.to(dt), idx,
                             model.box, activation=activation, lattice=lattice,
                             masks=masks, remat=model.cfg.remat).float()


def _run(form, dtype, remat, activation, parent, monkeypatch):
    """Prediction, loss and parameter gradients of one step, with the
    network of this tree or (parent) the layer code before the fusion."""
    if parent:
        monkeypatch.setattr(ts, "shiftinv_network", _parent_network)
        monkeypatch.setattr(ts, "_shiftinv_network_blocks", _parent_network_blocks)
    x_in, y = split_batch(torch.from_numpy(features_from_raw(
        synthetic_raw_cubes(2, CELLS, seed=0))))
    model = build_model(C.ModelConfig(
        channels=CHANNELS, k_neighbors=K, knn_window=2, seed=3, dtype=dtype,
        remat=remat, **_route(form)), box=4.0 * CELLS, device="cpu")
    pred = _forward(model, x_in, activation)
    assert model.impl_record["impl"] == ("masked" if form == "block" else "direct")
    (pred * y).sum().backward()
    monkeypatch.undo()
    return pred.detach(), [p.grad for p in model.params.parameters()]


@pytest.mark.parametrize("form,dtype,remat,activation", [
    ("cube", "float32", False, torch.relu),
    ("cube", "float32", True, torch.relu),
    ("cube", "float32", False, torch.tanh),
    ("cube", "bfloat16", False, torch.relu),
    ("block", "bfloat16", False, torch.relu),
    ("block", "bfloat16", True, torch.relu),
    ("block", "bfloat16", False, torch.tanh),
])
def test_network_matches_the_layer_before_the_fusion(form, dtype, remat,
                                                     activation, monkeypatch):
    """Both network forms with the fused epilogue against the same network
    on the parent's layer code (the chain, the activation after it): the
    output bit-equal, every parameter gradient within f32 tolerance (bf16:
    the fused backward sums its broadcast gradients in f32)."""
    got, grads = _run(form, dtype, remat, activation, False, monkeypatch)
    want, want_grads = _run(form, dtype, remat, activation, True, monkeypatch)
    assert torch.equal(got, want)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(grads, want_grads):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("form", ["cube", "block"])
def test_step_and_forward_count_the_epilogue(form, monkeypatch):
    """One train step runs the epilogue's forward and backward once a
    layer (the wrappers counted as the card counts a launch); a forward
    under no_grad, as a rollout hop runs it, runs the forward alone."""
    for name in ("epilogue4_forward", "epilogue4_backward"):
        def counted(*args, _orig=getattr(E4, name), _name=name):
            tracing.count(f"launch.{_name}")
            return _orig(*args)
        monkeypatch.setattr(E4, name, counted)
    x_in, y = split_batch(torch.from_numpy(features_from_raw(
        synthetic_raw_cubes(2, CELLS, seed=1))))
    model = build_model(C.ModelConfig(
        channels=CHANNELS, k_neighbors=K, knn_window=2, dtype="bfloat16",
        **_route(form)), box=4.0 * CELLS, device="cpu")
    layers = len(CHANNELS) - 1

    def moved(fn):
        before = tracing.counters()
        fn()
        return {k[len("launch."):]: v for k, v in tracing.delta(before).items()
                if k.startswith("launch.epilogue4")}

    assert moved(lambda: (model(x_in) * y).sum().backward()) == {
        "epilogue4_forward": layers, "epilogue4_backward": layers}
    with torch.no_grad():
        assert moved(lambda: model(x_in)) == {"epilogue4_forward": layers}


def _operands(q=8, dt=torch.float32, **odd):
    """h1, h2, h3, h4, bias of the check at width q (b 2, N 3, K 4), one
    replaced where `odd` names it."""
    ops = dict(h1=torch.zeros(2, 3, 4, q, dtype=dt), h2=torch.zeros(2, 3, 4, q, dtype=dt),
               h3=torch.zeros(2, 3, q, dtype=dt), h4=torch.zeros(2, q, dtype=dt),
               bias=torch.zeros(q, dtype=dt))
    ops.update(odd)
    return ops.values()


def test_kernel_check_takes_the_model_operands():
    """The check passes what both network forms hand the kernel: one f32 or
    bf16 dtype, the cube form's and the block-major form's shapes, a
    strided h1."""
    for dt in (torch.float32, torch.bfloat16):
        E4._check(*_operands(64, dt))
        E4._check(*_operands(256, dt))
        E4._check(*_operands(8, dt, h1=torch.zeros(2, 3, 4, 16, dtype=dt)[..., :8]))
        E4._check(torch.zeros(2, 2, 3, 4, 6, dtype=dt), torch.zeros(2, 2, 3, 4, 6, dtype=dt),
                  torch.zeros(2, 2, 3, 6, dtype=dt), torch.zeros(2, 6, dtype=dt),
                  torch.zeros(6, dtype=dt))


@pytest.mark.parametrize("ops,match", [
    (_operands(8, torch.float64), "one dtype"),
    (_operands(8, bias=torch.zeros(8, dtype=torch.bfloat16)), "one dtype"),
    (_operands(8, h2=torch.zeros(2, 3, 5, 8)), "takes h1, h2"),
    (_operands(8, h3=torch.zeros(2, 3, 1, 8)), "takes h1, h2"),
    (_operands(8, h4=torch.zeros(1, 8)), "takes h1, h2"),
    (_operands(8, bias=torch.zeros(1, 8)), "takes h1, h2"),
    (_operands(8, h1=torch.zeros(3, 8), h2=torch.zeros(3, 8)), "takes h1, h2"),
    (_operands(257), "widths up to"),
])
def test_kernel_check_refuses(ops, match):
    """On a card the wrapper raises ValueError for operands its kernel does
    not take, as the port's other kernel wrappers do, and runs no other
    path."""
    with pytest.raises(ValueError, match=match):
        E4._check(*ops)
