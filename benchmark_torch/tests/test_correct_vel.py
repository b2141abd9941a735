"""The comparison that decides ``correct`` in the velocity cell
(shiftinv_vel-64.train_index), shown to fail: on the CPU, at a size a test
run holds, a sound run is correct, and the control (the plain reference in
float8 e4m3 in the program's place) and each planted fault (state
unchanged, half of the batch, velocities zeroed) read past the cell's
limits.

    python -m pytest benchmark_torch/tests/test_correct_vel.py -q

The limits are the cell's own (benchmark_torch/limits/); the runs go
through harness.execute, past its look for a card, on a tiny cell: an 8^3
cube, K 6, narrow layers from 9 inputs to 6 outputs.  The readings at the
cell's full size on the card come from the driver's ``train_readings``.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from benchmark_torch import calibrate, harness
from benchmark_torch.drivers import train_scan_vel as D
from benchmark_torch.tests.tiny import TINY_CONFIG, TINY_TRAFFIC

CELL = "shiftinv_vel-64.train_index"
TINY_VEL = {**TINY_CONFIG, "channels": [9, 8, 16, 8, 6]}


def _cell(**config) -> harness.Cell:
    cell = harness.find_cell(CELL)
    traffic = {**cell.traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                                  if k in cell.traffic}}
    return dataclasses.replace(cell, config={**cell.config, **TINY_VEL, **config},
                               traffic=traffic)


def _run(tamper=None) -> dict:
    torch.manual_seed(0)
    run = harness.Run(_cell(), 11, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), tamper)
    return harness.execute(run)


def _fails(readings: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in readings.items() if k in limits)


def test_sound_run_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


def test_control_is_not_correct():
    """The control at a cube at which float8 reads past a limit on the CPU
    (its gaps grow with the cube: float8 keeps 3 bits of a position up to
    the box, 4 x cells; at 16^3 b2 it reads a grad gap of 0.10, at 24^3
    b1 0.89), with the published widths."""
    cell = _cell(cells=24, num_samples=3, channels=[9, 32, 64, 64, 32, 16, 6])
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "batch": 1})
    got = D.train_readings(cell, 5, torch.device("cpu"), control=True, program=False)
    assert _fails(got["control_fp8"], cell.limits), got


def _state_unchanged(trainer, feed):
    trainer.optimizer.step = lambda *args, **kwargs: None


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "velocities_zeroed"])
def test_fault_is_not_correct(fault):
    tamper = {"state_unchanged": _state_unchanged, "half_batch": calibrate.half_batch,
              "velocities_zeroed": D.velocities_zeroed}[fault]
    line = _run(tamper)
    assert not line["correct"], line["checks"]
