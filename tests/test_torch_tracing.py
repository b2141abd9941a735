"""The port's own tracing (nbody_tpu_torch/tracing.py) on the CPU, and the
benchmark's readers of it (benchmark_torch/metrics/*.train.py).

The step timeline's names and order on the direct and a masked route of
both graph families, with segments that sum to the step; no timeline, no
mark and no autograd node without a profiler, in a train step and in a
rollout hop; --remat marks each layer once; fit_scan's counters (the
particles that reach the loss, the wrappers' launches) and its samples,
one a chunk and only under a profiler; the program's span names in a
profiler's events; each new reader on a hand-made view and store, and a
loss over half the batch reading a loss-particle share of 50.  On the
card the step timeline is captured into fit_scan's CUDA graph and the
graph's counts added at each replay (chip_smoke.py phase 18).
"""

import os
import re
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark_torch.harness import load_module
from benchmark_torch.yardstick import samples
from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.data.dataset import Dataset, split_batch
from nbody_tpu_torch.io_.saver import Saver
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops.kernels import banded_kernels
from nbody_tpu_torch.physics.losses import loss_za
from nbody_tpu_torch.train.rollout import make_rollout, stack_params
from nbody_tpu_torch.train.trainer import (Trainer, TrainScan, make_optimizer,
                                           make_train_step)

torch.set_num_threads(1)

CELLS, K, BATCH = 8, 6, 2
N = CELLS ** 3
CHANNELS = (3, 8, 8, 3)
LAYERS = len(CHANNELS) - 1
METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark_torch", "metrics")
# the direct route of both families and one masked route of each
ROUTES = {"direct": {}, "index": dict(dtype="bfloat16", mask_dtype="index"),
          "block": dict(neighbor_impl="block")}


def _cfg(family="shiftinv", num_iters=6, **model):
    return C.Config(
        data=C.DataConfig(data_dir=os.path.join(os.sep, "nonexistent"),
                          num_test=2, num_val=1, cells_per_side=CELLS,
                          synthetic_num_samples=10),
        model=C.ModelConfig(family=family, channels=CHANNELS, k_neighbors=K,
                            knn_window=2, seed=3, **model),
        train=C.TrainConfig(num_iters=num_iters, batch_size=BATCH,
                            learn_rate=1e-3, checkpoint_every=1))


@pytest.fixture(scope="module")
def dataset():
    return Dataset(_cfg().data)


def _batch(dataset):
    return split_batch(torch.as_tensor(dataset.X_train[:BATCH]))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _step_marks(layers=LAYERS):
    fwd = [f"layer{i}" for i in range(layers)]
    bwd = [f"layer{i}.backward" for i in reversed(range(layers))]
    return (["start", "knn", "plan", "features"] + fwd + ["loss"] + bwd
            + ["backward", "adam"])


# the layout work ops/blocked.py marks (tracing.layout)
LAYOUT = re.compile(r"^(block_patches|patches_fold|edges_cube_to_blocks|"
                    r"nodes_blocks_to_cube)\d+(\.backward)?(\.layout)?$")


def _without_layout(names):
    return [n for n in names if not LAYOUT.match(n)]


@pytest.mark.parametrize("family,route", [
    ("shiftinv", "direct"), ("shiftinv15", "direct"),
    ("shiftinv", "index"), ("shiftinv15", "block")])
def test_step_timeline_names_order_and_sum(dataset, family, route):
    """Under a profiler an eager step's timeline holds every mark once, in
    stream order, its segments non-negative and summing to the step; the
    masked and block routes' layout marks besides (the direct route has
    none)."""
    model = build_model(_cfg(family, **ROUTES[route]).model, box=dataset.box,
                        device="cpu")
    step = make_train_step(model, make_optimizer(model, 1e-3))
    x, y = _batch(dataset)
    with _cpu_profile():
        t0 = time.perf_counter()
        step(x, y)
        wall = time.perf_counter() - t0
    if route != "direct":
        assert model.impl_record["impl"] in ("masked", "block")
    tl = step.timeline
    assert tl is not None and _without_layout(tl.names) == _step_marks()
    assert (tl.names == _step_marks()) == (route == "direct")
    assert len(set(tl.names)) == len(tl.names)
    seg = tl.segments_ms()
    assert list(seg) == tl.names[1:]
    assert all(v >= 0.0 for v in seg.values())
    total = sum(seg.values())
    assert 0.5 * 1e3 * wall <= total <= 1e3 * wall
    phases = [samples.phase_ms(seg, p) for p in samples.PHASES]
    assert sum(phases) == pytest.approx(total, rel=1e-9)


def _nodes(t):
    """Every autograd node reachable from t."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        stack.extend(g for g, _ in f.next_functions)
    return seen


@pytest.mark.parametrize("family", ["shiftinv", "shiftinv15"])
def test_no_timeline_without_profiler(dataset, family, monkeypatch):
    """With no profiler an eager step opens no timeline and records no
    mark, and its autograd graph has exactly the nodes it has with the
    tracing calls taken out; an open timeline adds one node a layer."""
    model = build_model(_cfg(family).model, box=dataset.box, device="cpu")
    x, y = _batch(dataset)
    before = tracing.counters()
    step = make_train_step(model, make_optimizer(model, 1e-3))
    step(x, y)
    assert step.timeline is None
    plain = _nodes(loss_za(model(x), y))
    assert "timeline.marks" not in tracing.delta(before)
    assert not any("Probe" in f.name() for f in plain)
    with monkeypatch.context() as m:
        m.setattr(tracing, "probe", lambda h, name: h)
        m.setattr(tracing, "mark", lambda name: None)
        assert len(_nodes(loss_za(model(x), y))) == len(plain)
    with tracing.timeline("cpu", always=True) as tl:
        traced = _nodes(loss_za(model(x), y))
    assert len(traced) == len(plain) + LAYERS
    assert tl.names == ["knn", "plan", "features"] + [
        f"layer{i}" for i in range(LAYERS)]


@pytest.mark.parametrize("profiled", [False, True])
def test_rollout_hop_opens_no_timeline(dataset, profiled):
    """A rollout hop marks nothing, with or without a profiler; under one
    each hop and each coverage count is a span."""
    model = build_model(_cfg().model, box=dataset.box, device="cpu")
    params = stack_params([dict(model.named_parameters())] * 2)
    x0 = torch.as_tensor(dataset.X_train[:BATCH, :, :6])
    rollout = make_rollout(model, coverage_fn=lambda x: torch.zeros(()))
    before = tracing.counters()
    if profiled:
        with _cpu_profile() as prof:
            rollout(params, x0)
        names = [e.name for e in prof.events()]
        assert names.count("rollout.hop") == 2
        assert names.count("rollout.monitor") == 2
    else:
        rollout(params, x0)
    assert "timeline.marks" not in tracing.delta(before)


@pytest.mark.parametrize("family", ["shiftinv", "shiftinv15"])
def test_remat_marks_each_layer_once(dataset, family):
    model = build_model(_cfg(family, remat=True).model, box=dataset.box,
                        device="cpu")
    step = make_train_step(model, make_optimizer(model, 1e-3))
    with _cpu_profile():
        step(*_batch(dataset))
    assert step.timeline.names == _step_marks()


def _layout_forward(layers):
    """The forward marks of a 4-op (and velocity) step on the index route:
    the features' gather, the edges into block-major order, the in-degree
    fold, each layer's fold and patches, the output back to the cube."""
    def pair(name):
        return [name, name + ".layout"]
    names = (["start", "knn", "plan"] + pair("block_patches0") + ["features"]
             + pair("edges_cube_to_blocks0") + pair("patches_fold0"))
    for i in range(layers):
        names += pair(f"patches_fold{i + 1}") + pair(f"block_patches{i + 1}") + [f"layer{i}"]
    return names + pair("nodes_blocks_to_cube0") + ["loss"]


VEL_CHANNELS = (9, 8, 4, 6)


@pytest.mark.parametrize("family", ["shiftinv", "shiftinv_vel", "shiftinv15"])
def test_layout_marks_in_order(family):
    """On the index route a profiled step marks each layout call on both
    sides, forward (``X`` then ``X.layout``) and backward (``X.backward``
    then ``X.backward.layout``), every name once; the 4-op forward (the
    velocity model's too) in the order of its calls; layout_ms.train
    reads the sum of the .layout segments."""
    velocity = family == "shiftinv_vel"
    cfg = _cfg(family, dtype="bfloat16", mask_dtype="index")
    if velocity:
        cfg = C.Config(data=C.DataConfig(**{**vars(cfg.data), "include_velocity": True}),
                       model=C.ModelConfig(**{**vars(cfg.model), "channels": VEL_CHANNELS}),
                       train=cfg.train)
    ds = Dataset(cfg.data)
    model = build_model(cfg.model, box=ds.box, device="cpu")
    step = make_train_step(model, make_optimizer(model, 1e-3))
    x, y = split_batch(torch.as_tensor(ds.X_train[:BATCH]), 9 if velocity else 6)
    with _cpu_profile():
        step(x, y)
    names = step.timeline.names
    assert model.impl_record["impl"] == "masked"
    assert len(set(names)) == len(names) and _without_layout(names) == _step_marks()
    loss_at = names.index("loss")
    if family != "shiftinv15":
        assert names[:loss_at + 1] == _layout_forward(LAYERS)
    tags = [n for n in names if LAYOUT.match(n) and not n.endswith((".layout", ".backward"))]
    assert tags and all(names[names.index(t) + 1] == t + ".layout" for t in tags)
    back = [n[:-len(".backward")] for n in names[loss_at:] if n.endswith(".backward")
            and LAYOUT.match(n)]
    assert back and set(back) <= set(tags)
    assert all(names[names.index(t + ".backward") + 1] == t + ".backward.layout"
               for t in back)
    seg = step.timeline.segments_ms()
    want = sum(v for k, v in seg.items() if k.endswith(".layout"))
    store = [{"steps": 1, "device_ms": seg, "counts": {}}]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tracing, "samples", lambda: store)
        assert _reader("layout_ms.train").read(_view(units=1)) == pytest.approx(want)


def test_layout_adds_no_node_without_profiler(dataset, monkeypatch):
    """With no profiler an index-route step marks nothing, and its
    autograd graph has exactly the nodes it has with the layout marks taken
    out; an open timeline adds two nodes a layout call that has a
    gradient."""
    model = build_model(_cfg(dtype="bfloat16", mask_dtype="index").model,
                        box=dataset.box, device="cpu")
    x, y = _batch(dataset)
    before = tracing.counters()
    plain = _nodes(loss_za(model(x), y))
    assert "timeline.marks" not in tracing.delta(before)
    assert not any("Probe" in f.name() for f in plain)
    with monkeypatch.context() as m:
        m.setattr(tracing, "layout", lambda name, fn, v, *args: fn(v, *args))
        assert len(_nodes(loss_za(model(x), y))) == len(plain)
    with tracing.timeline("cpu", always=True):
        traced = _nodes(loss_za(model(x), y))
    # at 3-8-8-3 layer 0 pools the features, which need no gradient: the
    # pools of layers 1 and 2 and the output's move to the cube have one
    with_grad = ["patches_fold2", "block_patches2", "patches_fold3",
                 "block_patches3", "nodes_blocks_to_cube0"]
    assert len(traced) == len(plain) + LAYERS + 2 * len(with_grad)


def test_host_knn_span_and_rows(dataset, monkeypatch):
    """Above EXACT_KNN_MAX_PARTICLES the coverage check's host k-d tree
    counts the b x N rows it searched as coverage.host_rows, and under a
    profiler the search is the span coverage.host_knn."""
    from nbody_tpu_torch.models import registry
    monkeypatch.setattr(registry, "EXACT_KNN_MAX_PARTICLES", N - 1)
    cfg = _cfg().model
    x, _ = _batch(dataset)
    before = tracing.counters()
    with _cpu_profile() as prof:
        v = registry.coverage_violations(cfg, dataset.box, x)
    assert v == 0
    assert tracing.delta(before).get("coverage.host_rows") == BATCH * N
    assert "coverage.host_knn" in _event_names(prof)
    monkeypatch.setattr(registry, "EXACT_KNN_MAX_PARTICLES", N)
    before = tracing.counters()
    registry.coverage_violations(cfg, dataset.box, x)
    assert "coverage.host_rows" not in tracing.delta(before)


def _counting_gather(monkeypatch):
    """Count each call of kernel B's wrapper as a launch, as it counts on
    the card (on the CPU the wrapper takes its plain version)."""
    orig = banded_kernels.neighbor_gather

    def gather(values, idx):
        tracing.count("launch.neighbor_gather")
        return orig(values, idx)

    monkeypatch.setattr(banded_kernels, "neighbor_gather", gather)


def _launches(d):
    return {k: v for k, v in d.items() if k.startswith("launch.")}


@pytest.mark.parametrize("steps,chunk", [(6, 3), (5, 2)])
def test_fit_scan_counters(dataset, monkeypatch, steps, chunk):
    """fit_scan of T steps at batch b moves loss.particles by T*b*N and
    every launch counter by T times one step's launches."""
    _counting_gather(monkeypatch)
    trainer = Trainer(_cfg(), "cpu", dataset=dataset)
    before = tracing.counters()
    trainer.train_step(*_batch(dataset))
    one = _launches(tracing.delta(before))
    assert one.get("launch.neighbor_gather", 0) > 0
    before = tracing.counters()
    trainer.fit_scan(num_iters=steps, scan_chunk=chunk, verbose=False)
    moved = tracing.delta(before)
    assert moved["loss.particles"] == steps * BATCH * N
    assert _launches(moved) == {k: steps * v for k, v in one.items()}


@pytest.mark.parametrize("profiled", [False, True])
def test_samples_one_a_chunk_under_a_profiler(dataset, profiled):
    """samples() stays empty without a profiler and takes one sample a
    chunk under a CPU profiler, with the chunk's steps, its last step's
    timeline (also the record's device_ms) and its counter deltas."""
    tracing.reset()
    trainer = Trainer(_cfg(), "cpu", dataset=dataset)
    if profiled:
        with _cpu_profile():
            trainer.fit_scan(num_iters=5, scan_chunk=2, verbose=False)
    else:
        trainer.fit_scan(num_iters=5, scan_chunk=2, verbose=False)
    got = tracing.samples()
    recs = [r for r in trainer.metrics_log if "step" in r]
    if not profiled:
        assert got == [] and not any("device_ms" in r for r in recs)
        return
    assert [s["steps"] for s in got] == [2, 2, 1]
    for s, rec in zip(got, recs):
        assert list(s["device_ms"]) == _step_marks()[1:]
        assert rec["device_ms"] == s["device_ms"]
        assert s["counts"]["loss.particles"] == s["steps"] * BATCH * N
    tracing.reset()
    assert tracing.samples() == [] and tracing.counters() == {}


def _event_names(prof):
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("entry", ["fit_scan", "fit"])
def test_program_spans_in_profiler_events(dataset, tmp_path, entry):
    """The trainer's, the coverage checks' and the Saver's spans appear in
    a CPU profiler's events."""
    saver = Saver(0, model_tag="spans", experiments_dir=str(tmp_path))
    trainer = Trainer(_cfg(), "cpu", dataset=dataset, saver=saver)
    with _cpu_profile() as prof:
        if entry == "fit_scan":
            trainer.fit_scan(num_iters=4, scan_chunk=2, verbose=False)
        else:
            trainer.fit(num_iters=2, verbose=False)
    want = {"coverage.exact", "coverage.monitor", "saver.save_checkpoint",
            "saver.append_metrics"}
    if entry == "fit_scan":
        want |= {"fit_scan.stage", "fit_scan.steps", "fit_scan.read_losses"}
    assert want <= _event_names(prof)


def _reader(name):
    return load_module(os.path.join(METRICS, f"{name}.py"), f"reader_{name}")


def _view(units, kernels=(), host_events=(), batch=BATCH, cells=CELLS):
    cell = types.SimpleNamespace(traffic={"batch": batch},
                                 config={"cells": cells})
    return types.SimpleNamespace(units=units, kernels=list(kernels),
                                 host_events=list(host_events), window_s=1.0,
                                 cell=cell)


def _sample(steps, particles, fwd=(1.0, 2.0), bwd=(3.0, 0.5), adam=0.25):
    device_ms = {"knn": fwd[0], "layer0": fwd[1], "loss": 0.0,
                 "layer0.backward": bwd[0], "backward": bwd[1], "adam": adam}
    return {"steps": steps, "device_ms": device_ms,
            "counts": {"loss.particles": particles}}


# a store: an older run's sample, then a window of 2 chunks of 2 steps
STORE = [_sample(3, 0, fwd=(50.0, 50.0)),
         _sample(2, 2 * BATCH * N, fwd=(1.0, 2.0), bwd=(3.0, 1.0), adam=0.5),
         _sample(2, 2 * BATCH * N, fwd=(2.0, 3.0), bwd=(4.0, 2.0), adam=1.5)]


@pytest.mark.parametrize("name,want", [
    ("forward_ms.train", 4.0), ("backward_ms.train", 5.0),
    ("adam_ms.train", 1.0), ("loss_particle_share.train", 100.0)])
def test_sample_readers(monkeypatch, name, want):
    """Each reader of the program's samples on a hand-made store: the
    window's samples only, nothing where they do not add up to the window
    or the program has no tracing module."""
    reader = _reader(name)
    monkeypatch.setattr(tracing, "samples", lambda: list(STORE))
    assert reader.read(_view(units=4)) == pytest.approx(want)
    assert reader.read(_view(units=5)) is None
    monkeypatch.setattr(tracing, "samples", lambda: [])
    assert reader.read(_view(units=4)) is None
    monkeypatch.setattr(tracing, "samples", lambda: list(STORE))
    monkeypatch.setitem(sys.modules, "nbody_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["nbody_tpu_torch"], "tracing")
    assert reader.read(_view(units=4)) is None


@pytest.mark.parametrize("ranges,want_ms", [
    # two saves of 10 ms: the first with 4 ms of kernels in it (two of
    # them overlapping), the second with one kernel straddling its start
    ([(1.000, 1.010), (2.000, 2.010)], (6.0 + 8.0) / 2),
    ([], None)])
def test_checkpoint_stall_reader(ranges, want_ms):
    kernels = [("k", 1.001, 1.003), ("k", 1.002, 1.004), ("k", 1.008, 1.009),
               ("k", 1.995, 2.002), ("k", 3.0, 3.5)]
    host = [("saver.save_checkpoint", s, e) for s, e in ranges] + [
        ("bench: Saver.save_checkpoint", 0.9, 2.1), ("fit_scan.steps", 0.0, 0.9)]
    got = _reader("checkpoint_stall_ms.train").read(
        _view(units=20, kernels=kernels, host_events=host))
    if want_ms is None:
        assert got is None
    else:
        assert got == pytest.approx(want_ms)


def _half_loss(pred, true):
    half = pred.shape[0] // 2
    return loss_za(pred[:half], true[:half])


@pytest.mark.parametrize("loss_fn,share", [(loss_za, 100.0), (_half_loss, 50.0)])
def test_loss_particle_share_reads_the_program(dataset, loss_fn, share):
    """A profiled fit_scan read by the reader: 100 for the whole batch, 50
    for a loss over half of it."""
    tracing.reset()
    trainer = Trainer(_cfg(), "cpu", dataset=dataset)
    trainer.train_scan = TrainScan(trainer.model, trainer.optimizer, loss_fn)
    with _cpu_profile():
        trainer.fit_scan(num_iters=4, scan_chunk=2, verbose=False)
    got = _reader("loss_particle_share.train").read(_view(units=4))
    assert got == pytest.approx(share)
    assert np.isfinite(trainer.train_error_history).all()
