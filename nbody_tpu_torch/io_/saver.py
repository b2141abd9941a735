"""Experiment naming, result persistence, metrics log (port of
nbody_tpu/io_/saver.py; reference Saver, utils.py:424-515).

Random constellation model tags, the {experiments_dir}/{name}/{Session,
Results} layout, np.save of the error arrays and the prediction cube, a
structured metrics.jsonl, and console reports.  The .npy artifacts keep
the JAX package's (and the reference's) layout -- error_test.npy,
error_training.npy and X_{i}_prediction.npy of shape (2, ntest, N,
out_ch), f32 -- so nbody_tpu/viz reads a port run's Results directory as
it reads a JAX run's.  Checkpoints are the port's own torch files
(io_/checkpoint.py).  While a profiler records, a checkpoint save and a
metrics append are the spans ``saver.save_checkpoint`` and
``saver.append_metrics`` (tracing.py).
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Optional

import numpy as np

from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.io_ import checkpoint


def random_model_tag(rng: Optional[random.Random] = None) -> str:
    """Three random constellation names (reference utils.py:452-454)."""
    rng = rng or random
    return "-".join(rng.choices(C.MODEL_TAGLIST, k=3))


class Saver:
    """Pathing + persistence for one experiment (reference utils.py:430-515).

    Attrs
    -----
    name    : model name, e.g. 'ZA-FPM_2_erid-ursa-hyda'
    results : '{experiments_dir}/{name}/Results'
    params  : '{experiments_dir}/{name}/Session'
    """

    def __init__(self, label_idx: int, model_tag: str = "",
                 experiments_dir: Optional[str] = None,
                 basename: str = C.MODEL_NAME_ZA, cube_name: str = C.CUBE_NAME):
        if model_tag == "":
            model_tag = random_model_tag()
        self.name = basename.format(f"{label_idx}_{model_tag}")
        self.cube = cube_name.format(label_idx)
        root = os.path.join(experiments_dir or C.default_experiments_dir(),
                            self.name)
        self.results = os.path.join(root, "Results")
        self.params = os.path.join(root, "Session")
        os.makedirs(self.results, exist_ok=True)
        os.makedirs(self.params, exist_ok=True)
        self._metrics_path = os.path.join(root, "metrics.jsonl")
        print(f"MODEL NAMED: {self.name}")

    # --- checkpoints -------------------------------------------------------
    def save_checkpoint(self, state: Any, step: int) -> str:
        with tracing.span("saver.save_checkpoint"):
            return checkpoint.save_checkpoint(self.params, state, step)

    def restore_checkpoint(self, state: Any, step: Optional[int] = None) -> int:
        return checkpoint.restore_checkpoint(self.params, state, step)

    # --- results (np.save layout identical to the reference) --------------
    def save_error(self, error: np.ndarray, training: bool = False) -> str:
        suffix = "training" if training else "test"
        dst = os.path.join(self.results, f"error_{suffix}")
        np.save(dst, error)
        print(f"Saved model {suffix} error: {dst}.npy")
        return dst + ".npy"

    def save_cube(self, cube: np.ndarray, ground_truth: bool = False) -> str:
        suffix = "truth" if ground_truth else "prediction"
        dst = os.path.join(self.results, f"{self.cube}_{suffix}")
        np.save(dst, cube)
        print(f"Saved {suffix} cube: {dst}.npy")
        return dst + ".npy"

    # --- metrics -----------------------------------------------------------
    def append_metrics(self, record: dict):
        with tracing.span("saver.append_metrics"), \
                open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # --- console reports (reference utils.py:500-515) ----------------------
    @staticmethod
    def print_checkpoint(step: int, err: float):
        print(f"Checkpoint {step + 1:>5} : {err:.6f}")

    @staticmethod
    def print_evaluation_results(err: np.ndarray, label: str = "Test"):
        print("\n".join([f"\n# {label} Error\n# {'=' * 17}",
                         f"  median : {np.median(err): .5f}",
                         f"    mean : {np.mean(err): .5f} +- {np.std(err): .4f} stdv"]))
