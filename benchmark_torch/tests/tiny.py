"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, for
the benchmark's own tests: an 8^3 cube, K 6, narrow layers, a short
chain.  The CPU runs the program's plain kernels; the numbers it gives
are no measurement of the card."""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark_torch import harness

TINY_CONFIG = {"cells": 8, "k_neighbors": 6, "channels": [3, 8, 16, 8, 3],
               "num_samples": 12}
TINY_TRAFFIC = {"batch": 2, "scan_chunk": 2, "hops": 3, "warm_chains": 1,
                "sample_range": 3}


def tiny_cell(name: str, **limits) -> harness.Cell:
    cell = harness.find_cell(name)
    config = {**cell.config, **TINY_CONFIG}
    traffic = {**cell.traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                                  if k in cell.traffic}}
    return dataclasses.replace(cell, config=config, traffic=traffic,
                               limits={**cell.limits, **limits})


def run_tiny(name: str, seed: int = 11, tamper=None, seconds: float = 0.2,
             **limits) -> dict:
    """One run of the tiny cell on the CPU -> its result line."""
    torch.manual_seed(0)
    run = harness.Run(tiny_cell(name, **limits), seed, seconds, False,
                      torch.device("cpu"), time.perf_counter(), tamper)
    return harness.execute(run)
