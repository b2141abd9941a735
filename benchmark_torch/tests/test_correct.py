"""The comparison that decides ``correct``, shown to fail: on the CPU, at a
size a test run holds, each cell's control (the plain reference in
float8 e4m3 in the program's place) and each fault the cell can have
(planted in the timed path, under the rest of a run) must read past the
cell's limits, and a sound run must not.

    python -m pytest benchmark_torch/tests -q

The limits are the cells' own (benchmark_torch/limits/); the runs go
through harness.execute, past its look for a card, on tiny cells
(tests/tiny.py).  The readings at the cells' full sizes on the card are
benchmark_torch/calibrate.py's.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark_torch import calibrate, harness
from benchmark_torch.tests.tiny import run_tiny

TRAIN_CELLS = ("shiftinv.train", "shiftinv15.train", "shiftinv15.train_index")
CELLS = TRAIN_CELLS + ("shiftinv.rollout",)


def _fails(readings: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in readings.items())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    line = run_tiny(workload)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


# the control's test sizes: the smallest at which the control reads past a
# limit on the CPU (its gaps grow with the cube: float8 keeps 3 bits of a
# position up to the box, 4 x cells; at 16^3 b2 the 15-op control reads a
# grad gap of 0.14, at 24^3 0.66); the published widths
CONTROL_SIZES = {"shiftinv.train": (32, 1), "shiftinv15.train": (24, 2),
                 "shiftinv15.train_index": (24, 2), "shiftinv.rollout": (32, 1)}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cells, batch = CONTROL_SIZES[workload]
    cell = harness.find_cell(workload)
    cell = dataclasses.replace(
        cell, config={**cell.config, "cells": cells, "num_samples": batch + 2},
        traffic={**cell.traffic, "batch": batch,
                 **({"hops": 3} if "hops" in cell.traffic else {})})
    read = (calibrate.rollout_readings if workload.endswith("rollout")
            else calibrate.train_readings)
    got = read(cell, 5, torch.device("cpu"), control=True, program=False)
    assert _fails(got["control_fp8"], cell.limits), got


def _state_unchanged(trainer, feed):
    trainer.optimizer.step = lambda *args, **kwargs: None


def _knn_altered(trainer, feed):
    """Particle 0's last neighbour id replaced by particle 2's, two lattice
    sites along z (inside the search window, but not among its nearest),
    where kernel A hands the ids on."""
    knn_fn = trainer.model.knn_fn

    def altered(x_in):
        idx = knn_fn(x_in).clone()
        idx[0, 0, -1] = 2
        return idx

    trainer.model.knn_fn = altered


# No training cell runs on more than one chip: there is no exchange
# between chips to leave out.
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "knn_altered"])
@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_train_fault_is_not_correct(workload, fault):
    tamper = {"state_unchanged": _state_unchanged, "half_batch": calibrate.half_batch,
              "knn_altered": _knn_altered}[fault]
    line = run_tiny(workload, tamper=tamper)
    assert not line["correct"], line["checks"]


def _chain_fault(kind):
    def tamper(rollout):
        def broken(stacked, x0):
            disp, (traj, counts) = rollout(stacked, x0)
            traj = traj.clone()
            mid = traj.shape[0] // 2
            if kind == "hop_unchanged":
                traj[mid] = traj[mid - 1] if mid else x0[..., 3:6]
            elif kind == "half_batch":
                traj[:, traj.shape[1] // 2:] = x0[traj.shape[1] // 2:, :, 3:6]
            else:                       # one particle's answer altered
                traj[mid:, 0, 0, 0] += 4.0      # one grid spacing
            return traj[-1], (traj, counts)
        return broken
    return tamper


@pytest.mark.parametrize("kind", ["hop_unchanged", "half_batch", "answer_altered"])
def test_rollout_fault_is_not_correct(kind):
    line = run_tiny("shiftinv.rollout", tamper=_chain_fault(kind))
    assert not line["correct"], line["checks"]
