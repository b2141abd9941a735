#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's compared numbers over many seeds, and the
control's and the planted faults' over a few.

    python3 benchmark_torch/calibrate.py --workload shiftinv.train \\
        --seeds 1 2 3 ... --control_seeds 1 2 3 [--out FILE]

Training cells, for every seed: the program's first three steps (the
benchmark's set-up, without the window) and its kNN ids against the
plain reference; for the control seeds also the control (the reference
in float8 e4m3, the precision below the configuration's bf16, in the
program's place) and the fault "half of the batch left out, the mean
taken over the rest", planted in the program (its feed hands it each
batch's first half twice; the reference gets the whole batch).  The
fault "a step that returns its state unchanged" reads 1 on grad_gap and
update_gap by their measure and needs no run.

Rollout cells, for every seed: two chains of the program against the
reference, hop by hop; for the control seeds also the control (the
reference chain in float8 e4m3) and the faults "a hop that returns its
input unchanged", "half of the batch left out" and "one particle's
answer altered" (its x moved by one grid spacing from the middle hop
on), planted in the reference chain as the tests plant them in the
program's.

Each reading is printed as one JSON line; the benchmark's own runs never
run this.  Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checks(cks):
    return {c.name: c.value for c in cks}


def half_batch(trainer, feed):
    """Planted fault: the program trains on the first half of each batch
    (twice, so its mean is the half's); the feed records the whole."""
    import numpy as np
    choice = feed.choice

    def first_half(n, size, replace=False):
        rows = choice(n, size, replace)
        k = size // 2
        return np.concatenate([rows[:k], rows[:size - k]])

    feed.choice = first_half


def train_readings(cell, seed, device, control: bool, program: bool = True) -> dict:
    """The compared numbers of the program (unless `program` is False:
    then the feed's first three batches are drawn without the program)
    and, with `control`, of the control and of the program on half its
    batch."""
    import torch
    from benchmark_torch import compare, harness
    from benchmark_torch.drivers import train_scan as D
    from benchmark_torch.reference import common

    def program_run(tamper):
        run = harness.Run(cell, seed, 0.0, False, device, time.perf_counter(), tamper)
        with tempfile.TemporaryDirectory(prefix="bench_calib_") as wd:
            trainer, hook, feed, ds, ref_x, layers = D.build(run, wd)
            got = D.host(D.first_steps(trainer, hook, feed, run))
            got["knn"] = D.program_knn(trainer, ds, feed, run)
            del trainer, hook
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return run, got, feed, ref_x, layers

    out = {"seed": seed}
    if program:
        run, prog, feed, ref_x, layers = program_run(None)
    else:
        run = harness.Run(cell, seed, 0.0, False, device, time.perf_counter())
        ds, ref_x, feed, layers = D.data(run)
        for _ in range(3):
            feed.choice(ds.X_train.shape[0], cell.traffic["batch"])
    ref = D.host(D.reference_steps(run, ref_x, feed, layers))
    out["losses"] = {"reference": ref["losses"], "reference_per_cube": ref["per_cube"]}
    if program:
        out["program"] = _checks(compare.train_checks(prog, ref, cell.limits))
        out["losses"]["program"] = prog["losses"]
    if control:
        ctl = D.host(D.reference_steps(run, ref_x, feed, layers, cast=common.fp8))
        ctl["knn"] = ref["knn"]          # the reference searches in float32
        out["control_fp8"] = _checks(compare.train_checks(ctl, ref, cell.limits))
        if program:
            _, half, half_feed, _, _ = program_run(half_batch)
            same = all((a == b).all() for a, b in zip(half_feed.batches[:3], feed.batches[:3]))
            out["fault_half_batch"] = _checks(compare.train_checks(half, ref, cell.limits))
            out["fault_half_batch"]["same_rows"] = bool(same)
            out["losses"]["half_batch"] = half["losses"]
    return out


def rollout_readings(cell, seed, device, control: bool, program: bool = True) -> dict:
    """The compared numbers of two of the program's chains (unless
    `program` is False: then the chains' inputs only are drawn) and, with
    `control`, of the control and the planted faults on the first."""
    import numpy as np
    import torch
    from benchmark_torch import compare, harness
    from benchmark_torch.drivers import rollout as D
    from benchmark_torch.reference import common
    run = harness.Run(cell, seed, 0.0, False, device, time.perf_counter())
    rollout, stacked, pool, ref_pool, layers = D.build(run)
    b = cell.traffic["batch"]
    order = np.random.default_rng(harness.derive_seed(seed, 2))
    kept = {}
    for i in range(2):
        rows = order.choice(pool.shape[0], b, replace=False)
        x0 = pool.index_select(0, torch.as_tensor(rows, device=device))
        kept[i] = (rows, rollout(stacked, x0)[1][0] if program else None)
    del rollout, stacked
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed}
    if program:
        out["program"] = _checks(compare.rollout_checks(
            D.reference_gaps(run, kept, ref_pool, layers), cell.limits))
    if not control:
        return out
    forward = cell.reference.make_forward(cell.config, cell.traffic["knn_window"])
    rows0 = kept[0][0]
    x0 = torch.as_tensor(ref_pool[rows0], device=device)
    q, hops = x0[..., :3], cell.traffic["hops"]

    def ref_chain(cast):
        disp, traj = x0[..., 3:6], []
        with torch.no_grad():
            for t in range(hops):
                hop = [{"W": l["W"][t], "B": l["B"][t]} for l in layers]
                disp = disp + torch.cat([forward(hop, torch.cat([q[j:j + 1], disp[j:j + 1]], -1),
                                                 cast) for j in range(b)])
                traj.append(disp)
        return torch.stack(traj)

    def reading(traj):
        return _checks(compare.rollout_checks(
            D.reference_gaps(run, {0: (rows0, traj)}, ref_pool, layers), cell.limits))

    out["control_fp8"] = reading(ref_chain(common.fp8))
    truth = ref_chain(common.identity)
    mid = hops // 2
    unchanged = truth.clone()
    unchanged[mid] = truth[mid - 1]
    out["fault_hop_unchanged"] = reading(unchanged)
    half = truth.clone()
    half[:, b // 2:] = x0[b // 2:, :, 3:6]
    out["fault_half_batch"] = reading(half)
    altered = truth.clone()
    altered[mid:, 0, 0, 0] += 4.0       # one grid spacing (box / cells)
    out["fault_answer_altered"] = reading(altered)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark_torch import harness
    from benchmark_torch.yardstick.peaks import power_limit
    cell = harness.find_cell(args.workload)
    device = harness.cuda_device(int(cell.entry["chips"]))
    readings = (rollout_readings if cell.traffic["driver"] == "rollout"
                else train_readings)
    lines = [{"workload": cell.name, "card": power_limit()}]
    print(json.dumps(lines[0]), flush=True)
    for seed in args.seeds:
        t = time.perf_counter()
        rec = readings(cell, seed, device, seed in args.control_seeds)
        rec["seconds"] = time.perf_counter() - t
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
