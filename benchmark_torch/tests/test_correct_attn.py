"""The comparison that decides ``correct`` in the attn cell (attn-32.train),
shown to fail: on the CPU, at a size a test run holds, a sound run is
correct, and the control (the program's step in bf16) and each planted
fault (state unchanged, half of the batch, the gate per sample, the batch
norm at frozen statistics, Adam's steps ten times too large) read past the
cell's limits.

    python -m pytest benchmark_torch/tests/test_correct_attn.py -q

The limits are the cell's own (benchmark_torch/limits/); the runs go
through harness.execute, past its look for a card, on a tiny cell: 8^3
cubes, b10 (the traffic's ten amplitude classes), three hidden layers of
width 16.  A tiny cell keeps few layers: at 8^3 the published 22 layers'
softmaxes are soft and float32 fixes none of the stack's numbers (the
reference's own float32 forward is O(1) off its float64,
tests/test_torch_attn_reference.py).  The readings at the cell's full
size on the card come from the driver's ``train_readings``.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from benchmark_torch import calibrate, harness
from benchmark_torch.drivers import train_scan_attn as D

CELL = "attn-32.train"
TINY = {"cells": 8, "num_samples": 20, "channels": [6, 16, 16, 16, 3]}


def _cell() -> harness.Cell:
    cell = harness.find_cell(CELL)
    return dataclasses.replace(cell, config={**cell.config, **TINY},
                               traffic={**cell.traffic, "scan_chunk": 2})


def _run(tamper=None) -> dict:
    torch.manual_seed(0)
    run = harness.Run(_cell(), 11, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), tamper)
    return harness.execute(run)


def test_sound_run_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", ["control_bf16", "state_unchanged", "half_batch",
                                   "gate_per_sample", "frozen_statistics", "lr_tenfold"])
def test_control_and_faults_are_not_correct(fault):
    tamper = {"control_bf16": D.program_bf16, "state_unchanged": D.state_unchanged,
              "half_batch": calibrate.half_batch, "gate_per_sample": D.gate_per_sample,
              "frozen_statistics": D.frozen_statistics, "lr_tenfold": D.lr_tenfold}[fault]
    line = _run(tamper)
    assert not line["correct"], line["checks"]
