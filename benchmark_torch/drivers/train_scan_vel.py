"""Driver of the traffic kind "train_scan_vel": the velocity model's
(shiftinv_vel) training run under ``Trainer.fit_scan``, the way ``cli/train
--velocity --scan T`` runs it.

Everything is drivers/train_scan.py's (its feed, Saver hook, window and
set-up, which this driver imports), on the joint position+velocity task:
the program's Dataset keeps the velocities (9 input and 6 target
columns), the reference trains on the benchmark's own velocity features
of the raw cubes (yardstick/features_vel.py), and the leaves compared are
every layer's W and B and the two output scalars T.  Set-up: the cubes
from the seed, one amplitude class a batch slot; one Trainer with the
training set on the card; the seeded weights, the last layer's scaled so
that the reference's prediction on the first training cube has the
traffic's ``pred_rms``, and T at the reference's 0.002, copied into the
model; the first three steps through fit_scan in chunks of one step; one
chunk of the window's length.  The window and the check are
drivers/train_scan.py's: knn_mismatch, loss_gap, grad_gap and update_gap
by compare.train_checks, the reference run cube by cube after the
program's state is freed.

``train_readings`` gives calibrate.train_readings' readings for a cell
of this driver (calibrate.py itself runs drivers/train_scan.py), and the
planted fault "velocities zeroed": the program trains on its features
with the three velocity inputs zeroed, the reference on the whole.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

from benchmark_torch import compare
from benchmark_torch.drivers.train_scan import (BETA1, NUM_TEST, NUM_VAL, ChunkHook,
                                                EpochFeed, _allocated, host, window)
from benchmark_torch.harness import Result, Run, TraceView, derive_seed, reduce_profile
from benchmark_torch.reference import common
from benchmark_torch.yardstick import features, features_vel
from benchmark_torch.yardstick.synthetic import synthetic_raw_cubes
from benchmark_torch.yardstick.weights import make_layers

# input columns of the velocity task: [grid - box/2, ZA displacement, ZA velocity]
NUM_INPUTS = 9


def _leaves(model):
    p = model.params
    return list(p.W) + list(p.B) + [p.T]


def data(run: Run):
    """The cell's cubes, the program's dataset of them (with velocities),
    the benchmark's own features of its training rows, the feed and the
    seeded parameters {"layers", "T"}, made from the seed."""
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
    ref_x = features_vel.features(raw[rows])
    del raw
    feed = EpochFeed(derive_seed(run.seed, 2), rows % len(amps))
    ref = run.cell.reference
    layers = make_layers(cfg["channels"], ref.NUM_WEIGHTS, ref.NUM_BIASES,
                         derive_seed(run.seed, 3), run.device)
    params = {"layers": [{"W": l["W"][0], "B": l["B"][0]} for l in layers],
              "T": torch.full((2,), ref.T_INIT, dtype=torch.float32, device=run.device)}
    forward = ref.make_forward(cfg, tr["knn_window"])
    with common.f32_within(), torch.no_grad():
        x0 = torch.as_tensor(ref_x[:1, :, :NUM_INPUTS], device=run.device)
        pred = forward(params, x0)
        rms = float(torch.sqrt(torch.mean(torch.sum(pred.double() ** 2, dim=-1))))
    last = params["layers"][-1]
    last["W"] = last["W"] * (tr["pred_rms"] / rms)
    run.log(f"{total} cubes made; last layer scaled by {tr['pred_rms'] / rms:.4g}")
    return dataset, ref_x, feed, params


def _config(run: Run, workdir: str):
    from nbody_tpu_torch import config as C
    cfg, tr = run.cell.config, run.cell.traffic
    return C.Config(
        data=C.DataConfig(num_test=NUM_TEST, num_val=NUM_VAL, cells_per_side=cfg["cells"],
                          include_velocity=True, synthetic_num_samples=cfg["num_samples"]),
        model=C.ModelConfig(family=cfg["family"], channels=tuple(cfg["channels"]),
                            k_neighbors=cfg["k_neighbors"], dtype=cfg["dtype"],
                            knn_window=tr["knn_window"],
                            mask_dtype=tr.get("mask_dtype", "auto")),
        train=C.TrainConfig(batch_size=tr["batch"], learn_rate=cfg["learn_rate"],
                            scan_chunk=tr["scan_chunk"], device_data="on",
                            experiments_dir=workdir, name="bench"))


def build(run: Run, workdir: str):
    """The trainer, its hook, its feed, its dataset, the reference's
    training rows and the seeded parameters."""
    import torch
    from nbody_tpu_torch.io_.saver import Saver
    from nbody_tpu_torch.train.trainer import Trainer

    dataset, ref_x, feed, params = data(run)
    hook = ChunkHook(Saver(0, model_tag="bench", experiments_dir=workdir), None)
    trainer = Trainer(_config(run, workdir), run.device, dataset=dataset, saver=hook)
    layers = params["layers"]
    with torch.no_grad():
        for p, v in zip(_leaves(trainer.model), [l["W"] for l in layers]
                        + [l["B"] for l in layers] + [params["T"]]):
            p.copy_(v)
    if run.tamper is not None:
        run.tamper(trainer, feed)
    run.log(f"trainer built; {_allocated(run)}")
    return trainer, hook, feed, dataset, ref_x, params


def first_steps(trainer, hook, feed, run: Run) -> dict:
    """Steps 1-3 through fit_scan in chunks of one step: the losses, the
    first gradient as Adam got it and the change after step 3, of every
    leaf, T included."""
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


def program_knn(trainer, dataset, feed, run: Run):
    """The program's kNN ids of the first batch, by the model's own
    knn_fn on its own inputs of the batch."""
    import torch
    x = torch.as_tensor(dataset.X_train[feed.batches[0]][..., :NUM_INPUTS],
                        device=run.device)
    with torch.no_grad():
        return trainer.model.knn_fn(x).cpu()


def reference_steps(run: Run, ref_x, feed, params, cast=common.identity,
                    batch_keep: float = 1.0) -> dict:
    """The plain reference's first three steps on the rows the program
    trained on, and its kNN ids and positions of the first batch."""
    import torch
    cfg, tr = run.cell.config, run.cell.traffic
    ref = run.cell.reference
    common.strict_f32()
    forward = ref.make_forward(cfg, tr["knn_window"])
    batches = []
    for rows in feed.batches[:3]:
        x = torch.as_tensor(ref_x[rows], device=run.device)
        batches.append((x[..., :NUM_INPUTS], x[..., NUM_INPUTS:]))
    losses, grads, deltas, per_cube = ref.train_steps(
        forward, params["layers"], params["T"], batches, cfg["learn_rate"], cast,
        batch_keep)
    _, _, pos_norm = common.graph_geometry(batches[0][0], 4.0 * cfg["cells"])
    knn = common.lattice_knn(pos_norm, cfg["k_neighbors"], cfg["cells"], tr["knn_window"])
    return {"losses": losses, "grads": grads, "deltas": deltas,
            "per_cube": per_cube, "knn": knn.cpu(), "pos_norm": pos_norm.cpu()}


def run(run: Run) -> Result:
    import torch
    workdir = tempfile.mkdtemp(prefix="bench_train_vel_")
    try:
        trainer, hook, feed, dataset, ref_x, params = build(run, workdir)
        prog = first_steps(trainer, hook, feed, run)
        run.log(f"first steps: losses {prog['losses']}; family "
                f"{trainer.cfg.model.family}, {dataset.cells}^3, b{run.cell.traffic['batch']}; "
                f"route {trainer.model.impl_record}; {_allocated(run)}")
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
        prog["knn"] = program_knn(trainer, dataset, feed, run)
        del trainer, hook, dataset
        if cuda:
            torch.cuda.empty_cache()
        ref = host(reference_steps(run, ref_x, feed, params))
        run.log(f"reference losses {ref['losses']}")
        checks = compare.train_checks(prog, ref, run.cell.limits)
        e2e = {"setup_s": t_setup - run.t0,
               "train_particle_steps_per_s": steps * n / secs}
        return Result(e2e, steps, failed, checks, peak, view)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def velocities_zeroed(trainer, feed):
    """Planted fault: the program's velocity inputs are zero (its training
    set's columns 6-8, before fit_scan copies it to the card)."""
    trainer.dataset.X_train[..., 6:NUM_INPUTS] = 0.0


def train_readings(cell, seed, device, control: bool, program: bool = True) -> dict:
    """calibrate.train_readings for a cell of this driver: the compared
    numbers of the program (unless `program` is False: then the feed's
    first three batches are drawn without the program) and, with
    `control`, of the control (the reference in float8 e4m3), of the
    program on half its batch and of the program with its velocities
    zeroed."""
    import torch
    from benchmark_torch import calibrate, harness

    def program_run(tamper):
        r = harness.Run(cell, seed, 0.0, False, device, time.perf_counter(), tamper)
        with tempfile.TemporaryDirectory(prefix="bench_calib_") as wd:
            trainer, hook, feed, ds, ref_x, params = build(r, wd)
            got = host(first_steps(trainer, hook, feed, r))
            got["knn"] = program_knn(trainer, ds, feed, r)
            del trainer, hook, ds
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return r, got, feed, ref_x, params

    def readings(got, ref):
        return {c.name: c.value for c in compare.train_checks(got, ref, cell.limits)}

    out = {"seed": seed}
    if program:
        r, prog, feed, ref_x, params = program_run(None)
    else:
        r = harness.Run(cell, seed, 0.0, False, device, time.perf_counter())
        ds, ref_x, feed, params = data(r)
        for _ in range(3):
            feed.choice(ds.X_train.shape[0], cell.traffic["batch"])
        del ds
    ref = host(reference_steps(r, ref_x, feed, params))
    out["losses"] = {"reference": ref["losses"], "reference_per_cube": ref["per_cube"]}
    if program:
        out["program"] = readings(prog, ref)
        out["losses"]["program"] = prog["losses"]
    if control:
        ctl = host(reference_steps(r, ref_x, feed, params, cast=common.fp8))
        ctl["knn"] = ref["knn"]          # the reference searches in float32
        out["control_fp8"] = readings(ctl, ref)
        if program:
            for name, tamper in (("fault_half_batch", calibrate.half_batch),
                                 ("fault_velocities_zeroed", velocities_zeroed)):
                _, got, got_feed, _, _ = program_run(tamper)
                out[name] = readings(got, ref)
                out[name]["same_rows"] = all(
                    (a == b).all() for a, b in zip(got_feed.batches[:3], feed.batches[:3]))
                out["losses"][name] = got["losses"]
    return out
