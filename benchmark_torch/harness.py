"""The benchmark's harness: one run of one cell, found by name.

    python3 benchmark_torch/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything a cell needs is found by the names in BENCHMARK.json, at the
root of the checkout: the workload's entry names its configuration
(``benchmark_torch/configs/<config>.json``) and its traffic mix
(``benchmark_torch/traffic/<traffic>.json``); the traffic names its driver
(``benchmark_torch/drivers/<driver>.py``); the configuration names its
family, whose counts (``counts/<family>.py``) and plain reference
(``reference/<family>.py``) the driver uses; the cell's limits on the
compared numbers are ``limits/<workload>.json``; and each per-layer
metric is read by ``metrics/<metric>.py``.  A later change adds a cell, a
configuration or a metric by adding files and entries.

A run loads, warms up the shapes of its cell, measures for ``--seconds``
(or, with ``--trace 1``, profiles a short window of the same loop), checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output.  It refuses to run without a CUDA
card: no number from the CPU is printed under a device metric's name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK_JSON = os.path.join(ROOT, "BENCHMARK.json")


class BenchmarkError(RuntimeError):
    """The run cannot produce a result (no card, unknown name, bad file)."""


def load_json(path: str) -> dict:
    if not os.path.exists(path):
        raise BenchmarkError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file of the benchmark by its path (names hold dots)."""
    if not os.path.exists(path):
        raise BenchmarkError(f"missing file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def derive_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run's randomness (data, feed,
    weights, sample), the same for the same --seed."""
    import numpy as np
    ss = np.random.SeedSequence([seed & (2 ** 64 - 1), stream])
    return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files loaded."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    counts: object          # counts/<family>.py
    reference: object       # reference/<family>.py
    driver: object          # drivers/<driver>.py
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    """A metric is reported in the cells it lists; an end-to-end metric
    that lists none (setup_s) in every cell."""
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """Load the workload `name` and everything it names."""
    bench = bench if bench is not None else load_json(BENCHMARK_JSON)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[entry["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
    family = config["family"]
    counts = load_module(os.path.join(HERE, "counts", f"{family}.py"),
                         f"benchmark_torch.counts.{family}")
    reference = load_module(os.path.join(HERE, "reference", f"{family}.py"),
                            f"benchmark_torch.reference.{family}")
    driver = load_module(os.path.join(HERE, "drivers", f"{traffic['driver']}.py"),
                         f"benchmark_torch.drivers.{traffic['driver']}")
    unlisted = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if unlisted:
        raise BenchmarkError(f"per-layer metrics {unlisted} list no workloads")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, entry, config, traffic, limits, counts, reference, driver,
                e2e, per_layer)


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments and its device."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                                  # the process's start
    # a test's hook on the program under test (None in a benchmark run)
    tamper: Optional[Callable] = None
    # spans (name, start, end) on the host clock, from the benchmark's files
    spans: List[tuple] = dataclasses.field(default_factory=list)

    def log(self, msg: str):
        print(f"[{time.perf_counter() - self.t0:8.2f}s] {msg}", file=sys.stderr,
              flush=True)


@dataclasses.dataclass
class Check:
    """One compared number and its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Result:
    """What a driver returns."""
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional["TraceView"] = None


class TraceView:
    """A profiled window reduced for the per-layer readers: the device
    kernels (name, start s, end s), the host operations, the units (steps
    or hops) the window completed and its host-clock length."""

    def __init__(self, kernels, host_events, units: int, window_s: float,
                 cell: Cell):
        from benchmark_torch.yardstick import buckets
        self.kernels = kernels
        self.host_events = host_events
        self.units = units
        self.window_s = window_s
        self.cell = cell
        self.busy_s = buckets.union_seconds([(s, e) for _, s, e in kernels])
        self.by_bucket = buckets.seconds_by(kernels, buckets.bucket_of)

    def bucket_seconds(self, *labels: str) -> float:
        return sum(self.by_bucket.get(label, 0.0) for label in labels)

    def unit_flops(self) -> float:
        return self.cell.counts.unit_flops(self.cell.config, self.cell.traffic)

    def neighbor_calls(self):
        return self.cell.counts.neighbor_calls(self.cell.config, self.cell.traffic)

    def breakdown(self) -> dict:
        from benchmark_torch.yardstick import buckets
        ops = buckets.seconds_by(self.kernels, lambda n: n[:120])
        top = sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:10]
        gaps = buckets.idle_gaps([(s, e) for _, s, e in self.kernels])
        return {"device_ops": top,
                "idle_gaps": buckets.name_gaps(gaps, self.host_events)}


def reduce_profile(prof):
    """(kernels, host events) of a torch.profiler window, in seconds: the
    device activities (kernels, copies, fills) and the host operations.
    User annotations (record_function ranges, which the profiler also
    draws on the device's timeline over the kernels they enclose) are
    host events only."""
    from torch.autograd import DeviceType
    kernels, host = [], []
    for ev in prof.events():
        rng = (ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
        if getattr(ev, "is_user_annotation", False):
            if ev.device_type == DeviceType.CPU:
                host.append((ev.name, *rng))
            continue
        if ev.device_type == DeviceType.CUDA:
            kernels.append((ev.name, *rng))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.name, *rng))
    return kernels, host


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_record(run: Run, result: Result) -> dict:
    import torch
    if run.device.type != "cuda":      # a test's run on the CPU
        return {"platform": "cpu", "kind": "cpu test run, not a measurement",
                "count": 1, "memory_peak_bytes": 0}
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
           "count": 1, "memory_peak_bytes": int(result.memory_peak_bytes)}
    if result.trace is not None:
        rec["busy_s"] = result.trace.busy_s
        rec["window_s"] = result.trace.window_s
    return rec


def per_layer_metrics(run: Run, view: "TraceView") -> dict:
    out = {}
    for m in run.cell.per_layer:
        reader = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                             f"benchmark_torch.metrics.{m['name']}")
        value = reader.read(view)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def span_summary(spans) -> dict:
    """{name: [count, total s, longest s]} of the run's host spans."""
    out: Dict[str, list] = {}
    for name, start, end in spans:
        rec = out.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += end - start
        rec[2] = max(rec[2], end - start)
    return out


def result_line(run: Run, result: Result) -> dict:
    """The last line of a run: correct, attempted, failed, metrics,
    device, breakdown (traced runs), the host spans and, last, the
    compared numbers."""
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end}
    if run.trace:
        metrics = per_layer_metrics(run, result.trace)
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in result.end_to_end.items() if k in units}
    line = {"correct": all(c.ok for c in result.checks) and bool(result.checks),
            "attempted": int(result.attempted), "failed": int(result.failed),
            "metrics": metrics, "device": device_record(run, result)}
    if run.trace:
        line["breakdown"] = result.trace.breakdown()
    line["spans"] = span_summary(run.spans)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in result.checks}
    return line


def execute(run: Run) -> dict:
    """Drive the cell once and build its result line (no card check:
    tests drive a tiny cell on the CPU through here)."""
    result = run.cell.driver.run(run)
    line = result_line(run, result)
    for c in result.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    return line


def cuda_device(chips: int):
    """The card the run uses; raises where there is no card, or fewer than
    the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        raise BenchmarkError("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise BenchmarkError(f"the cell needs {chips} cards, "
                             f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def main(args, t0: float) -> int:
    from benchmark_torch.yardstick import peaks
    smi = peaks.query_power_limit()
    try:
        cell = find_cell(args.workload)
        device = cuda_device(int(cell.entry["chips"]))
    except BenchmarkError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        peaks.read_power_limit(smi)
        return 1
    run = Run(cell, args.seed, float(args.seconds), bool(args.trace), device, t0)
    run.log(f"cell {cell.name}: config {cell.entry['config']}, traffic "
            f"{cell.entry['traffic']}, seed {args.seed}; card "
            f"{peaks.read_power_limit(smi)}")
    line = execute(run)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
