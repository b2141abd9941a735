"""The port's attn model against the benchmark's plain reference
(benchmark_torch/reference/attn.py), its FLOP count by hand, and its
tracing (the gate and norm segments and counters, tracing.segment).

On the benchmark's seeded parameters (drivers/train_scan_attn.make_params,
the last layer's Wh scaled to a prediction rms of 0.02 as the cell's
traffic does) at the published widths, ATTN_CHANNELS (6, 22 x 16, 3), on
8^3 and 16^3 cubes, b2, both gate forms: the forward, loss_za and every
leaf's gradient (the worst leaf's norm gap over max(its norm, the median
leaf's), as compare.norm_gap) of the port against the reference, in
float64 at both sizes and in float32 at 16^3 (at 8^3 float32 fixes
nothing: the reference's own float32 forward is O(1) off its float64).

Why each bar is the reference's own rounding times a factor: 22 layers of
mean-centring, channel gates and batch norm at random weights amplify
rounding, most where a gate's softmax is soft (at 512-1,024 rows a gram
the top two entries of a row lie within a few units, and the per-sample
gate's stack grows an error ~5x a layer: float64's 1e-16 reaches O(1) at
8^3 b4), and a soft softmax passes a gradient as exp(-gap), so a leaf
before it moves by a factor under one rounding.  So the port is held to
the reference as closely as the reference holds to itself: in float64 to
30 times what an f32 rounding of its input moves it (the port returns
float32 predictions, a rounding of that size), in float32 to 10 times its
own distance from float64; never looser than these readings call for and
never tighter than FLOOR (float64: forward and loss 1e-6, gradient 1e-4,
10x over the port's f32 output rounding as it reaches them; float32:
forward 1e-4, loss 1e-5, gradient 1e-2).  bf16 holds the repo's loss bar
(rtol 3e-2: the loss is the targets' to 1 %, the prediction being small);
its gradient does not hold a cosine of 0.998: bf16 rounds a gram entry of
1e3-1e5 by 4-400, past the gap of its row's top two, the gates flip and the
gradient turns (cosine -0.9 to 0.96 at these sizes), which is why bf16 is
the benchmark cell's control (PERF.md section 2).

    python -m pytest tests/test_torch_attn_reference.py -q --durations=5

~12 s on one worker.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark_torch.counts import attn as counts
from benchmark_torch.drivers.train_scan_attn import make_params
from benchmark_torch.harness import load_module
from benchmark_torch.reference import attn as ref
from benchmark_torch.reference import common
from benchmark_torch.yardstick import features
from benchmark_torch.yardstick.synthetic import synthetic_raw_cubes
from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.models.base import ATTN_KEYS
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.physics.losses import loss_za
from nbody_tpu_torch.train.trainer import make_optimizer, make_train_step

torch.set_num_threads(1)

CHANNELS = list(C.ATTN_CHANNELS)
NL = len(CHANNELS) - 1
BATCH = 2
PRED_RMS = 0.02
FLOOR = {torch.float64: {"fwd": 1e-6, "loss": 1e-6, "grad": 1e-4},
         torch.float32: {"fwd": 1e-4, "loss": 1e-5, "grad": 1e-2}}
FACTOR = {torch.float64: 30.0, torch.float32: 10.0}


def _inputs(cells, seed=4):
    x = features.features(synthetic_raw_cubes(BATCH, cells, seed=seed, za_rms=0.8))
    return torch.from_numpy(x[..., :6]), torch.from_numpy(x[..., 6:])


def _params(x, seed=101):
    layers = make_params(CHANNELS, seed, "cpu")
    with torch.no_grad():
        pred = ref.forward(layers, x[:1])
    layers[-1]["Wh"] = layers[-1]["Wh"] * (PRED_RMS / float(pred.double().pow(2).sum(-1).mean().sqrt()))
    return layers


def _port(cells, layers, dtype, coupled):
    model = build_model(C.ModelConfig(family="attn", channels=tuple(CHANNELS),
                                      batch_coupled_gate=coupled),
                        box=4.0 * cells, device="cpu")
    with torch.no_grad():
        for p, v in zip([t for key in ATTN_KEYS for t in getattr(model.params, key)],
                        ref.leaves(layers)):
            p.copy_(v)
    model.dtype = dtype          # the same forward computed in dtype
    return model


def _run_port(model, x, y):
    leaves = [t for key in ATTN_KEYS for t in getattr(model.params, key)]
    pred = model(x)
    loss = loss_za(pred, y)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return pred.detach(), float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                                 for p, g in zip(leaves, grads)]


def _run_ref(layers, x, y, dtype, coupled):
    leaves = [p.detach().to(dtype).requires_grad_(True) for p in ref.leaves(layers)]
    cur = [{key: leaves[k * NL + i] for k, key in enumerate(ref.KEYS)} for i in range(NL)]
    pred = ref.forward(cur, x.to(dtype), coupled=coupled)
    loss = common.loss_za(pred, y.to(dtype))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return pred.detach(), float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                                 for p, g in zip(leaves, grads)]


def _gaps(got, want):
    (pa, la, ga), (pb, lb, gb) = got, want
    pa, pb = pa.double(), pb.double()
    norms = [float(t.double().norm()) for t in gb]
    med = float(np.median(norms))
    return {"fwd": float((pa - pb).norm() / pb.norm()),
            "loss": abs(la - lb) / abs(lb),
            "grad": max(float((u.double() - v.double()).norm()) / max(n, med, 1e-30)
                        for u, v, n in zip(ga, gb, norms))}


# float32 at 8^3 is not compared: there the reference's own float32
# forward is O(1) off its float64 one (1.24 relative), so nothing is fixed
CASES = [(torch.float64, 8), (torch.float64, 16), (torch.float32, 16)]


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "per_sample"])
@pytest.mark.parametrize("dtype,cells", CASES, ids=["f64-8", "f64-16", "f32-16"])
def test_port_matches_reference(dtype, cells, coupled):
    x, y = _inputs(cells)
    layers = _params(x)
    want = _run_ref(layers, x, y, dtype, coupled)
    if dtype == torch.float64:
        u = torch.from_numpy(np.random.default_rng(0).choice([-1.0, 1.0], size=tuple(x.shape)))
        own = _gaps(_run_ref(layers, x.double() * (1.0 + 2.0 ** -24 * u), y, dtype, coupled), want)
    else:
        own = _gaps(want, _run_ref(layers, x, y, torch.float64, coupled))
    got = _gaps(_run_port(_port(cells, layers, dtype, coupled), x, y), want)
    for k, v in got.items():
        bar = max(FLOOR[dtype][k], FACTOR[dtype] * own[k])
        assert v <= bar, (k, got, own)


def test_bf16_loss_at_the_repo_bar():
    x, y = _inputs(16)
    layers = _params(x)
    _, want, _ = _run_ref(layers, x, y, torch.float32, True)
    _, got, _ = _run_port(_port(16, layers, torch.bfloat16, True), x, y)
    assert got == pytest.approx(want, rel=3e-2)


def test_counts_by_hand():
    """One layer 6 -> 16 and the output layer 16 -> 3, by hand: three
    products, the gram and the gate's product a layer, the residual in the
    hidden one."""
    n, b = 8 ** 3, 3
    hidden = 3 * 6 * 16 + 16 * 16 + 16 * 16 + 6 * 16
    last = 3 * 16 * 3 + 3 * 3 + 3 * 3
    assert counts.forward_flops(n, b, [6, 16, 3]) == 2.0 * b * n * (hidden + last)
    cfg, traffic = {"cells": 8, "channels": [6, 16, 3]}, {"batch": b}
    assert counts.unit_flops(cfg, traffic) == 3 * 2.0 * b * n * (hidden + last)
    assert counts.neighbor_calls(cfg, traffic) is None


# ---- tracing --------------------------------------------------------------

def _attn_marks(nl=NL):
    fwd, bwd = [], []
    for i in range(nl):
        fwd += [f"gate{i}", f"gate{i}.gate"]
        bwd = [f"gate{i}.backward", f"gate{i}.backward.gate"] + bwd
        if i < nl - 1:
            fwd += [f"norm{i}", f"norm{i}.norm"]
            bwd = [f"norm{i}.backward", f"norm{i}.backward.norm"] + bwd
    return ["start"] + fwd + ["loss"] + bwd + ["backward", "adam"]


def _reader(name):
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark_torch", "metrics", f"{name}.py")
    return load_module(path, f"benchmark_torch.metrics.{name}")


class _View:
    units = 1


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "per_sample"])
def test_step_marks_gate_and_norm_segments(coupled, monkeypatch):
    """Under a profiler a train step marks each of the 23 gates and 22 norms
    forward and backward, in order, every name once, and counts attn.gate
    23, attn.norm 22 and the rows the grams reduced; gate_ms.train and
    norm_ms.train read the sums of the .gate and .norm segments."""
    x, y = _inputs(8)
    model = _port(8, _params(x), torch.float32, coupled)
    step = make_train_step(model, make_optimizer(model, 1e-3))
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        step(x, y)
    assert step.timeline.names == _attn_marks()
    got = tracing.delta(before)
    n = 8 ** 3
    assert (got["attn.gate"], got["attn.norm"]) == (NL, NL - 1)
    assert got["attn.gate_rows"] == NL * (BATCH * n if coupled else n)
    seg = step.timeline.segments_ms()
    store = [{"steps": 1, "device_ms": seg, "counts": {}}]
    monkeypatch.setattr(tracing, "samples", lambda: store)
    for name, kind in (("gate_ms.train", ".gate"), ("norm_ms.train", ".norm")):
        want = sum(v for k, v in seg.items() if k.endswith(kind))
        assert _reader(name).read(_View()) == pytest.approx(want)


def _nodes(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        stack.extend(g for g, _ in f.next_functions)
    return seen


def test_no_timeline_no_mark_no_node(monkeypatch):
    """With no timeline open a forward marks nothing and has exactly the
    autograd nodes it has with the segments taken out."""
    x, y = _inputs(8)
    model = _port(8, _params(x), torch.float32, True)
    before = tracing.counters()
    plain = _nodes(loss_za(model(x), y))
    assert "timeline.marks" not in tracing.delta(before)
    assert not any("Probe" in f.name() for f in plain)
    monkeypatch.setattr(tracing, "segment", lambda kind, name, fn, v, *args: fn(v, *args))
    assert len(_nodes(loss_za(model(x), y))) == len(plain)


@pytest.mark.parametrize("kind", ["layout", "gate"])
def test_segment_names(kind):
    """tracing.segment's four marks; ``layout`` keeps the names the block
    layout's segments have always had (layout_ms.train reads them)."""
    x = torch.ones(4, 3, requires_grad=True)
    w = torch.ones(3, 2, requires_grad=True)
    with tracing.timeline("cpu", always=True) as tl:
        tracing.mark("start")
        if kind == "layout":
            out = tracing.layout("block_patches", lambda v: v * 2.0, x)
        else:
            out = tracing.segment(kind, "block_patches", torch.matmul, x, w)
        tracing.mark("end")
        out.sum().backward()
    tag = "block_patches0"
    assert tl.names == ["start", tag, f"{tag}.{kind}", "end", f"{tag}.backward",
                        f"{tag}.backward.{kind}"]
