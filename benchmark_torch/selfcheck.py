#!/usr/bin/env python3
"""The benchmark's check of its own yardsticks, on the CPU, with no card.

    python3 benchmark_torch/selfcheck.py

1. The useful-FLOP count (yardstick/flops.py) gives, at 32^3, batch 4,
   K 14 and 3-32-64-64-32-16-3, the values of nbody_tpu/utils/flops.py
   (pinned here: nothing of the JAX package is imported).
2. The traffic generator (yardstick/synthetic.py) is bit-equal to the
   program's nbody_tpu_torch/data/synthetic.py on one seed, and the
   reference's features and training split (yardstick/features.py) to
   the program's Dataset.
3. The logical gathers and scatters of one train step (counts/<family>.py)
   are the calls the program makes: one eager train step of each counted
   route on the CPU, at a small cube with the published widths, with the
   program's kernel wrappers (B, C, D, E) wrapped to record each call's
   shape.
4. Every workload of BENCHMARK.json finds its configuration, traffic,
   limits, counts, reference and driver by name, every per-layer metric
   its reader, and the file keeps the format the harness reads
   (names, units, lengths, keys, references between entries).
Exits 0 when every check holds; prints each.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_CHANNELS = [3, 32, 64, 64, 32, 16, 3]
# nbody_tpu/utils/flops.py useful_flops_train_step at 32^3, b4, K14
PINNED_FLOPS = {"shiftinv": 201_792_372_096, "shiftinv15": 452_293_621_248}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check(ok: bool, what: str, failures: list):
    print(f"{'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


def check_flops(failures):
    from benchmark_torch.yardstick.flops import train_step_flops
    for fam, want in PINNED_FLOPS.items():
        got = train_step_flops(fam, 32 ** 3, 4, 14, GRAPH_CHANNELS)
        check(got == want, f"{fam} train step FLOPs {got:.0f} == {want}", failures)


def check_generator(failures):
    import numpy as np
    os.environ["NBODY_SYNTH_CACHE_DIR"] = ""      # the program's cache off
    from benchmark_torch.yardstick.synthetic import synthetic_raw_cubes as mine
    from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes as theirs
    a, b = mine(3, 16, seed=20251, za_rms=0.8), theirs(3, 16, seed=20251, za_rms=0.8)
    check(a.dtype == b.dtype and np.array_equal(a, b),
          "generator bit-equal to nbody_tpu_torch/data/synthetic.py", failures)
    from benchmark_torch.yardstick import features
    from nbody_tpu_torch import config as C
    from nbody_tpu_torch.data.dataset import Dataset
    raw = mine(6, 8, seed=7)
    ds = Dataset(C.DataConfig(num_test=1, num_val=1, cells_per_side=8), raw=raw)
    x = features.features(raw)[features.train_rows(6, 1, 1)]
    check(x.dtype == ds.X_train.dtype and np.array_equal(x, ds.X_train),
          "reference features and split bit-equal to the program's Dataset", failures)


def observed_calls(cell, cells: int, batch: int):
    """The program's B, C, D and E calls of one eager train step on the
    CPU, as counts.common.Call tuples."""
    import torch
    from benchmark_torch.counts.common import Call
    from nbody_tpu_torch import config as C
    from nbody_tpu_torch.data.dataset import features_from_raw, split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.ops.kernels import banded_kernels as BK, idx_kernels as IK
    from nbody_tpu_torch.train.trainer import make_optimizer, make_train_step
    from benchmark_torch.yardstick.synthetic import synthetic_raw_cubes

    cfg, tr = cell.config, cell.traffic
    rows = batch * cells ** 3
    seen = []

    def gather(values, idx):
        seen.append(Call("gather", values.shape[0] * values.shape[1],
                         idx.numel(), values.shape[-1], values.element_size()))
        return orig["gather"](values, idx)

    def segsum(vals, plan):
        out = orig["segsum"](vals, plan)
        seen.append(Call("scatter", out.shape[0] * out.shape[1],
                         vals.numel() // vals.shape[-1], vals.shape[-1],
                         vals.element_size()))
        return out

    def dot_gather(pos, patches):
        seen.append(Call("gather", rows, pos.numel(), patches.shape[-1], 2))
        return orig["dot_gather"](pos, patches)

    def dot_scatter(plan, edges, p_size):
        seen.append(Call("scatter", rows, edges.numel() // edges.shape[-1],
                         edges.shape[-1], 2))
        return orig["dot_scatter"](plan, edges, p_size)

    orig = {"gather": BK.neighbor_gather, "segsum": BK.neighbor_segment_sum,
            "dot_gather": IK.dot_gather, "dot_scatter": IK.dot_scatter}
    x = torch.from_numpy(features_from_raw(synthetic_raw_cubes(batch, cells, seed=3)))
    x_in, y = split_batch(x)
    model = build_model(C.ModelConfig(
        family=cfg["family"], channels=tuple(cfg["channels"]),
        k_neighbors=cfg["k_neighbors"], dtype=cfg["dtype"],
        knn_window=tr["knn_window"], mask_dtype=tr.get("mask_dtype", "auto")),
        box=4.0 * cells, device="cpu")
    step = make_train_step(model, make_optimizer(model, 1e-3))
    BK.neighbor_gather, BK.neighbor_segment_sum = gather, segsum
    IK.dot_gather, IK.dot_scatter = dot_gather, dot_scatter
    try:
        step(x_in, y)
    finally:
        BK.neighbor_gather, BK.neighbor_segment_sum = orig["gather"], orig["segsum"]
        IK.dot_gather, IK.dot_scatter = orig["dot_gather"], orig["dot_scatter"]
    return seen, model.impl_record


def check_counts(failures):
    from benchmark_torch import harness
    from benchmark_torch.counts.common import call_bytes
    bench = harness.load_json(harness.BENCHMARK_JSON)
    cells, batch = 8, 2
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"], bench)
        small_cfg = {**cell.config, "cells": cells}
        small_tr = {**cell.traffic, "batch": batch}
        want = cell.counts.neighbor_calls(small_cfg, small_tr)
        if want is None:
            print(f"--   {w['name']}: no neighbor counts for this traffic")
            continue
        got, rec = observed_calls(dataclass_replace(cell, small_cfg, small_tr), cells, batch)
        same = collections.Counter(got) == collections.Counter(want)
        check(same, f"{w['name']} ({rec.get('impl')}, {rec.get('mask_dtype')}): "
                    f"{len(want)} counted calls, {sum(map(call_bytes, want))} logical "
                    f"bytes == the program's {len(got)} calls, "
                    f"{sum(map(call_bytes, got))} bytes", failures)
        if not same:
            print("     only counted:", collections.Counter(want) - collections.Counter(got))
            print("     only seen:   ", collections.Counter(got) - collections.Counter(want))


def dataclass_replace(cell, config, traffic):
    import dataclasses
    return dataclasses.replace(cell, config=config, traffic=traffic)


def check_files(failures):
    from benchmark_torch import harness
    bench = harness.load_json(harness.BENCHMARK_JSON)
    check(set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}, "BENCHMARK.json keys", failures)
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cellnames = {w["name"] for w in bench["workloads"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    check(all(NAME.match(n) for n in names) and len(names) == len(set(names)),
          "names well formed and distinct", failures)
    for c in bench["configs"]:
        check(set(c) == {"name", "source", "file", "reduced", "why"}
              and c["file"].startswith("benchmark_torch/")
              and harness.load_json(os.path.join(ROOT, c["file"]))["reduced"] == c["reduced"]
              and 1 <= len(c["why"]) <= 200,
              f"config {c['name']}: keys, file, reduced", failures)
    for w in bench["workloads"]:
        check(set(w) == {"name", "config", "traffic", "chips", "why"}
              and w["config"] in configs and w["chips"] in (1, 4)
              and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"]),
              f"workload {w['name']}: keys, config, why ({len(w['why'])} chars)", failures)
        try:
            harness.find_cell(w["name"], bench)
            found = True
        except harness.BenchmarkError as e:
            print("    ", e)
            found = False
        check(found, f"workload {w['name']}: every file found by name", failures)
    for m in bench["end_to_end"] + bench["per_layer"]:
        keys = set(m) - {"workloads"}
        want = ({"name", "unit", "better", "bound", "source"} if m in bench["end_to_end"]
                else {"name", "unit", "better", "source", "layer", "moves"})
        ok = (keys == want and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
              and set(m.get("workloads", [])) <= cellnames)
        if m in bench["per_layer"]:
            ok = ok and "workloads" in m and m["moves"] in e2e and os.path.exists(
                os.path.join(ROOT, "benchmark_torch", "metrics", f"{m['name']}.py"))
            ok = ok and m["source"] in ("device_trace", "program_span", "program_counter",
                                        "host_clock")
        else:
            ok = ok and m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        check(bool(ok), f"metric {m['name']}: keys, unit, reader", failures)
    for w in bench["workloads"]:
        reported = [m["name"] for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        layers = [m["name"] for m in bench["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        check("setup_s" in reported and len(reported) >= 2 and layers,
              f"workload {w['name']} reports {reported} and {len(layers)} per-layer metrics",
              failures)
    check(os.path.getsize(harness.BENCHMARK_JSON) <= 64 * 1024, "BENCHMARK.json size", failures)


def main() -> int:
    sys.path.insert(0, ROOT)
    failures: list = []
    check_flops(failures)
    check_generator(failures)
    check_files(failures)
    check_counts(failures)
    print(json.dumps({"selfcheck_ok": not failures, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
