#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark_torch/run.py --workload shiftinv.train --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout; the cells are BENCHMARK.json's workloads.
The last line on standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and the compared
numbers with their limits); the compared numbers are also the last lines
on standard error.  Exits 1 without printing a result where there is no
CUDA card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed cache directories inside the checkout, for any library that would
# compile (the program's own kernels build into build/nbody_tpu_torch/)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}
# one host thread for the CPU libraries: the card does the work, and a
# pool of spinning threads on a shared host made the 4-op cell's rate
# ~1 % slower and no steadier
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "benchmark_torch", sub)
    for var in THREADS:
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    from benchmark_torch import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
