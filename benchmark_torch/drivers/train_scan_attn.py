"""Driver of the traffic kind "train_scan_attn": the attention + residual
set network's (attn) training run under ``Trainer.fit_scan``, the way
``cli/experiment`` -> ``cli/train --model attn --scan T`` runs it.

Everything around the steps is drivers/train_scan.py's (its feed, Saver
hook and window, which this driver imports), on a family with no graph:
no kNN search, no neighbor route, no coverage check, so no knn_mismatch.
Set-up (counted in ``setup_s``): the traffic's cubes from the seed, one
amplitude class a batch slot (ten classes at batch 10: a batch's cubes
weigh 1 : 3^(-1/3) : ... : 3^(-3) in its loss, so a step on half of it
shows); one Trainer with the training set on the card (``device_data``
"on") and a Saver writing into a temporary directory; the seeded
parameters (``make_params``), the last layer's Wh scaled so that the
reference's prediction on the first training cube has the traffic's
``pred_rms``, copied into the model; the first three optimizer steps
through fit_scan in chunks of one step (the eager step, the capture of
the step's CUDA graph, a replay); then one chunk of the window's length.
The window is train_scan's.

The check (after the window, the program's state freed): the plain
reference (reference/attn.py) runs the same three steps on the same rows
from the same parameters, each batch whole (the gate and the batch
statistics couple its cubes), on the benchmark's own features of the raw
cubes (yardstick/features.py), and its first gradient again in float64,
also on nudged inputs; ``checks`` sets the program's first loss, first
gradient (Adam's first moment after step 1 over 1 - b1) and parameter
change after step 3 beside its, by compare.norm_gap over the leaves the
loss reaches and, for the gradient, float32 fixes (see ``checks``).

``train_readings`` gives the readings a limit is set from, with the
control (the program's step in bf16, the precision below the
configuration's f32) and the planted faults: half of the batch, the gate
per sample, the batch norm at frozen statistics, state unchanged, Adam's
steps ten times too large; and a TF32 run of the program for the
record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import shutil
import statistics
import tempfile
import time

import numpy as np

from benchmark_torch import compare
from benchmark_torch.drivers.train_scan import (BETA1, NUM_TEST, NUM_VAL, ChunkHook,
                                                EpochFeed, _allocated, host, window)
from benchmark_torch.harness import Check, Result, Run, TraceView, derive_seed, reduce_profile
from benchmark_torch.reference import common
from benchmark_torch.yardstick import features
from benchmark_torch.yardstick.synthetic import synthetic_raw_cubes

# input columns: [grid - box/2, ZA displacement]
NUM_INPUTS = 6
# the reference's bias init (experiment.py:54)
BIAS_INIT = 1e-6
# a leaf whose reference gradient norm is under this share of the largest
# leaf's is nought to rounding and not compared: the residual weights no
# output uses, the last layer's gamma and beta, every beta (the next
# layer's mean-centring removes a per-channel constant), and the Wf and
# Wg of a gate whose softmax is saturated; Adam would turn such a
# gradient's sign noise into steps of the full learning rate
LIVE_SHARE = 1e-5
# a leaf whose first gradient float32 fixes: its float64 gradient moves by
# at most this share of max(its norm, the median live leaf's) when the
# inputs are nudged by NUDGE (x (1 +- NUDGE), two draws): about what
# float32 rounds a sum over the batch's 327,680 rows by (2^-24 sqrt(K)
# = 3.4e-5 for K such terms), so that a leaf float32 does not fix moves
# by more than the program's rounding does (3-10 times, on the card)
FIXED_SHARE = 1e-2
NUDGE = 1e-5


def make_params(channels, seed: int, device):
    """[{"Wf", "Wg", "Wh", "R", "B", "gamma", "beta"}, ...] float32 on
    `device`: one draw from a generator on the device gives glorot-normal
    Wf, Wg, Wh (c, q) and R (channels[0], q) a layer; B is BIAS_INIT,
    gamma 1 and beta 0."""
    import torch
    pairs = list(zip(channels[:-1], channels[1:]))
    shapes = [s for c, q in pairs for s in ((c, q),) * 3 + ((channels[0], q),)]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(a * b for a, b in shapes), generator=gen, device=device,
                       dtype=torch.float32)
    parts = iter(torch.split(flat, [a * b for a, b in shapes]))
    layers = []
    for c, q in pairs:
        layer = {}
        for key in ("Wf", "Wg", "Wh", "R"):
            fan_in = channels[0] if key == "R" else c
            layer[key] = next(parts).reshape(fan_in, q) * math.sqrt(2.0 / (fan_in + q))
        layer["B"] = torch.full((q,), BIAS_INIT, dtype=torch.float32, device=device)
        layer["gamma"] = torch.ones(q, dtype=torch.float32, device=device)
        layer["beta"] = torch.zeros(q, dtype=torch.float32, device=device)
        layers.append(layer)
    return layers


def _leaves(model):
    from nbody_tpu_torch.models.base import ATTN_KEYS
    p = model.params
    return [t for key in ATTN_KEYS for t in getattr(p, key)]


def data(run: Run):
    """The cell's cubes, the program's dataset of them, the benchmark's own
    features of its training rows, the feed and the seeded parameters,
    made from the seed."""
    import torch
    from nbody_tpu_torch.data.dataset import Dataset
    cfg, tr = run.cell.config, run.cell.traffic
    amps, total = tr["za_rms"], cfg["num_samples"]
    per = -(-total // len(amps))
    parts = [synthetic_raw_cubes(per, cfg["cells"], seed=derive_seed(run.seed, 10 + c),
                                 za_rms=a) for c, a in enumerate(amps)]
    raw = np.stack(parts, axis=1).reshape((per * len(amps),) + parts[0].shape[1:])[:total]
    del parts
    dataset = Dataset(_config(run, "").data, raw=raw)
    rows = features.train_rows(total, NUM_TEST, NUM_VAL)
    ref_x = features.features(raw[rows])
    del raw
    feed = EpochFeed(derive_seed(run.seed, 2), rows % len(amps))
    layers = make_params(cfg["channels"], derive_seed(run.seed, 3), run.device)
    with torch.no_grad():
        x0 = torch.as_tensor(ref_x[:1, :, :NUM_INPUTS], device=run.device)
        with common.f32_within():
            pred = run.cell.reference.forward(layers, x0)
        rms = float(torch.sqrt(torch.mean(torch.sum(pred.double() ** 2, dim=-1))))
    layers[-1]["Wh"] = layers[-1]["Wh"] * (tr["pred_rms"] / rms)
    run.log(f"{total} cubes made; last layer's Wh scaled by {tr['pred_rms'] / rms:.4g}")
    return dataset, ref_x, feed, layers


def _config(run: Run, workdir: str):
    from nbody_tpu_torch import config as C
    cfg, tr = run.cell.config, run.cell.traffic
    return C.Config(
        data=C.DataConfig(num_test=NUM_TEST, num_val=NUM_VAL, cells_per_side=cfg["cells"],
                          synthetic_num_samples=cfg["num_samples"]),
        model=C.ModelConfig(family=cfg["family"], channels=tuple(cfg["channels"]),
                            dtype=cfg["dtype"],
                            batch_coupled_gate=cfg["batch_coupled_gate"]),
        train=C.TrainConfig(batch_size=tr["batch"], learn_rate=cfg["learn_rate"],
                            scan_chunk=tr["scan_chunk"], device_data="on",
                            experiments_dir=workdir, name="bench"))


def build(run: Run, workdir: str):
    """The trainer, its hook, its feed, its dataset, the reference's
    training rows and the seeded parameters."""
    import torch
    from nbody_tpu_torch.io_.saver import Saver
    from nbody_tpu_torch.train.trainer import Trainer

    dataset, ref_x, feed, layers = data(run)
    hook = ChunkHook(Saver(0, model_tag="bench", experiments_dir=workdir), None)
    trainer = Trainer(_config(run, workdir), run.device, dataset=dataset, saver=hook)
    with torch.no_grad():
        for p, v in zip(_leaves(trainer.model), run.cell.reference.leaves(layers)):
            p.copy_(v)
    if run.tamper is not None:
        run.tamper(trainer, feed)
    run.log(f"trainer built; {_allocated(run)}")
    return trainer, hook, feed, dataset, ref_x, layers


def first_steps(trainer, hook, feed, run: Run) -> dict:
    """Steps 1-3 through fit_scan in chunks of one step: the losses, the
    first gradient as Adam got it and the change after step 3, of every
    leaf (a leaf the loss does not reach has no Adam state: zero)."""
    import torch
    leaves = _leaves(trainer.model)
    start = [p.detach().clone() for p in leaves]
    got = {"losses": []}

    def on_chunk(tr):
        got["losses"].append(tr.metrics_log[-1]["loss"])
        if tr.step == 1:
            state = tr.optimizer.state
            got["grads"] = [state[p]["exp_avg"].detach() / (1.0 - BETA1)
                            if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                            for p in leaves]
        if tr.step == 3:
            got["deltas"] = [p.detach() - p0 for p, p0 in zip(leaves, start)]

    hook.on_chunk = on_chunk
    trainer.fit_scan(num_iters=3, rng=feed, scan_chunk=1, verbose=False)
    return got


def reference_steps(run: Run, ref_x, feed, layers) -> dict:
    """The plain reference's first three steps on the rows the program
    trained on; its first gradient also in float64 ("grads64") and, for
    each leaf, how far that moves when the inputs are nudged ("moved": the
    larger of two draws of x (1 +- NUDGE))."""
    import torch
    batches = []
    for rows in feed.batches[:3]:
        x = torch.as_tensor(ref_x[rows], device=run.device)
        batches.append((x[..., :NUM_INPUTS], x[..., NUM_INPUTS:]))
    ref = run.cell.reference
    losses, grads, deltas, per_cube = ref.train_steps(layers, batches,
                                                      run.cell.config["learn_rate"])
    x0, t0 = batches[0]
    _, grads64 = ref.gradient(layers, x0, t0, dtype=torch.float64)
    gen = torch.Generator().manual_seed(derive_seed(run.seed, 4))
    moved = [0.0] * len(grads64)
    for _ in range(2):
        sign = torch.randint(0, 2, x0.shape, generator=gen).to(run.device, torch.float64)
        x = x0.double() * (1.0 + NUDGE * (2.0 * sign - 1.0))
        _, again = ref.gradient(layers, x, t0, dtype=torch.float64)
        moved = [max(m, d) for m, d in zip(moved, _norms([a - g for a, g in zip(again, grads64)]))]
        del again
    return {"losses": losses, "grads": grads, "deltas": deltas, "per_cube": per_cube,
            "grads64": grads64, "moved": moved}


def _norms(ts):
    import torch
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def live_leaves(grads64):
    """The leaves whose first gradient is not nought to rounding: a float64
    norm of at least LIVE_SHARE of the largest leaf's."""
    norms = _norms(grads64)
    top = max(norms)
    return [n > 0.0 and n >= LIVE_SHARE * top for n in norms]


def fixed_leaves(grads64, moved, live):
    """Of the live leaves, those whose first gradient float32 fixes: a
    nudge of the inputs moves its float64 gradient by at most FIXED_SHARE
    of max(its norm, the median live leaf's).  A gate whose
    softmax is near a tie of gram entries of 1e5 and more passes a
    gradient as exp(-gap), and the gap's float32 rounding is of order 1:
    every leaf before such a gate, and after it those of layers whose
    gates are nearly as soft, take a gradient that another order of the
    same sums changes by 10-100 %, in the program and in the reference
    alike (PERF.md section 2)."""
    n64 = _norms(grads64)
    med = statistics.median(n for n, ok in zip(n64, live) if ok)
    return [ok and m <= FIXED_SHARE * max(n, med) for ok, m, n in zip(live, moved, n64)]


def checks(prog: dict, ref: dict, limits: dict):
    """loss_gap, grad_gap and update_gap by compare.py's measures: the first
    step's loss; the first gradient against the reference's float64 one
    on the leaves float32 fixes (``fixed_leaves``); the change after three
    steps.  Both norm gaps are scaled by the median live leaf
    (``live_leaves``), not by one of the nought ones, which are half of
    the leaves, nor by one of the fixed ones, which are the smaller half
    of the live (``fixed_leaves`` takes the same scale)."""
    p, r = prog["losses"][0], ref["losses"][0]
    loss_gap = abs(p - r) / max(abs(r), 1e-30)
    loss_gap = loss_gap if math.isfinite(loss_gap) else float("inf")
    live = live_leaves(ref["grads64"])
    fixed = fixed_leaves(ref["grads64"], ref["moved"], live)

    def pick(ts, mask):
        return [t for t, keep in zip(ts, mask) if keep]

    return [Check("loss_gap", loss_gap, limits["loss_gap"]),
            Check("grad_gap", compare.norm_gap(pick(prog["grads"], live),
                                               pick(ref["grads64"], live),
                                               pick(fixed, live)),
                  limits["grad_gap"]),
            Check("update_gap", compare.norm_gap(pick(prog["deltas"], live),
                                                 pick(ref["deltas"], live),
                                                 compare.counted_leaves(pick(ref["grads"], live))),
                  limits["update_gap"])]


def run(run: Run) -> Result:
    import torch
    workdir = tempfile.mkdtemp(prefix="bench_train_attn_")
    try:
        trainer, hook, feed, dataset, ref_x, layers = build(run, workdir)
        prog = first_steps(trainer, hook, feed, run)
        run.log(f"first steps: losses {prog['losses']}; family "
                f"{trainer.cfg.model.family}, {dataset.cells}^3, b{run.cell.traffic['batch']}, "
                f"{trainer.cfg.model.dtype}; {_allocated(run)}")
        steps, secs, failed, prof, t_setup = window(trainer, hook, feed, run)
        cuda = run.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
        n = run.cell.config["cells"] ** 3 * run.cell.traffic["batch"]
        run.log(f"window: {steps} steps in {secs:.3f} s; peak {peak} B")
        view = None
        if prof is not None:
            kernels, host_events = reduce_profile(prof)
            view = TraceView(kernels, host_events, steps, secs, run.cell)
        prog = host(prog)
        del trainer, hook, dataset
        if cuda:
            torch.cuda.empty_cache()
        ref = host(reference_steps(run, ref_x, feed, layers))
        run.log(f"reference losses {ref['losses']}")
        e2e = {"setup_s": t_setup - run.t0,
               "train_particle_steps_per_s": steps * n / secs}
        return Result(e2e, steps, failed, checks(prog, ref, run.cell.limits), peak, view)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def program_bf16(trainer, feed):
    """The control: the program's step computed in bf16 (its parameters
    and Adam stay f32), against the f32 reference."""
    import torch
    trainer.model.dtype = torch.bfloat16


def gate_per_sample(trainer, feed):
    """Planted fault: the program's gram per sample (its
    batch_coupled_gate off), the reference's over the batch."""
    trainer.model.cfg = dataclasses.replace(trainer.model.cfg, batch_coupled_gate=False)


def frozen_statistics(trainer, feed):
    """Planted fault: the program's batch norm at the frozen (0, 1)
    statistics in training (its eval-mode forward in the step)."""
    trainer.model.forward = trainer.model.apply_eval


def state_unchanged(trainer, feed):
    """Planted fault: a step that returns its state unchanged."""
    trainer.optimizer.step = lambda *args, **kwargs: None


def lr_tenfold(trainer, feed):
    """Planted fault: Adam's steps ten times the configured size."""
    for group in trainer.optimizer.param_groups:
        group["lr"] = 10.0 * group["lr"]


@contextlib.contextmanager
def tf32():
    """The program's f32 matmuls in TF32 for the block."""
    import torch
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def train_readings(cell, seed, device, control: bool) -> dict:
    """The compared numbers of the program against the reference for one
    seed and, with `control`, of the control (the program in bf16), of
    the planted faults (half of the batch, gate per sample, frozen
    statistics, state unchanged, Adam's steps ten times too large) and of
    the program in TF32."""
    import torch
    from benchmark_torch import calibrate, harness

    def program_run(tamper, ctx=contextlib.nullcontext):
        r = harness.Run(cell, seed, 0.0, False, device, time.perf_counter(), tamper)
        with tempfile.TemporaryDirectory(prefix="bench_calib_") as wd, ctx():
            trainer, hook, feed, ds, ref_x, layers = build(r, wd)
            got = host(first_steps(trainer, hook, feed, r))
            del trainer, hook, ds
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return r, got, feed, ref_x, layers

    def readings(got, ref):
        return {c.name: c.value for c in checks(got, ref, cell.limits)}

    r, prog, feed, ref_x, layers = program_run(None)
    ref = host(reference_steps(r, ref_x, feed, layers))
    live = live_leaves(ref["grads64"])
    out = {"seed": seed, "program": readings(prog, ref),
           "losses": {"reference": ref["losses"], "reference_per_cube": ref["per_cube"],
                      "program": prog["losses"]},
           "live_leaves": sum(live),
           "fixed_leaves": sum(fixed_leaves(ref["grads64"], ref["moved"], live))}
    if control:
        runs = (("control_bf16", program_bf16, contextlib.nullcontext),
                ("program_tf32", None, tf32),
                ("fault_half_batch", calibrate.half_batch, contextlib.nullcontext),
                ("fault_gate_per_sample", gate_per_sample, contextlib.nullcontext),
                ("fault_frozen_statistics", frozen_statistics, contextlib.nullcontext),
                ("fault_state_unchanged", state_unchanged, contextlib.nullcontext),
                ("fault_lr_tenfold", lr_tenfold, contextlib.nullcontext))
        for name, tamper, ctx in runs:
            _, got, got_feed, _, _ = program_run(tamper, ctx)
            out[name] = readings(got, ref)
            out[name]["same_rows"] = all(
                (a == b).all() for a, b in zip(got_feed.batches[:3], feed.batches[:3]))
            out["losses"][name] = got["losses"]
    return out
