"""Training loop (port of nbody_tpu/train/trainer.py; reference
train.py:84-182).

One step rebuilds the kNN graph (one fused CUDA kernel), runs forward
and backward through the CUDA gather / scatter kernels, and applies Adam
(``torch.optim.Adam`` with optax.adam's betas and eps; the update formulas
agree).  PyTorch runs eagerly, so the step is a plain function.  The
device is explicit.

Coverage guard: the JAX trainer only warns when the lattice window cannot
represent the data; the port refuses, as bench.py:192-199 does.  The exact
check runs on the first batch of every ``fit``, and the O(N) margin
monitor at every checkpoint triggers one exact check per episode of
margin violations.  After the first step the model's effective neighbor
route (``impl_record``: direct, block, or masked with its core and mask
dtype, index, int8 or int4) is printed and logged, as _log_effective_impl
does in JAX.  Sharded, ensemble
and scan training, saving and restore are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import Dataset, make_dataset, split_batch
from nbody_tpu_torch.models.registry import (ShiftInvModel, build_model,
                                             coverage_violations)
from nbody_tpu_torch.ops.knn import lattice_violations
from nbody_tpu_torch.physics.losses import loss_za


class CoverageError(RuntimeError):
    """The lattice kNN window drops edges on this data: the model would
    train on a silently corrupted graph."""


def make_optimizer(model: torch.nn.Module, learn_rate: float) -> torch.optim.Adam:
    """optax.adam(lr) counterpart: b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.Adam(model.parameters(), lr=learn_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def make_train_step(model: ShiftInvModel, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = loss_za):
    """(x_in, y_true) -> loss (a device scalar; reading it synchronizes)."""

    def step(x_in: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x_in), y_true)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_eval_step(model: ShiftInvModel, loss_fn: Callable = loss_za):
    """(x_in, y_true) -> (pred, loss), without gradients."""

    @torch.no_grad()
    def step(x_in: torch.Tensor, y_true: torch.Tensor):
        pred = model(x_in)
        return pred, loss_fn(pred, y_true)

    return step


class Trainer:
    """End-to-end orchestration (the reference train.py loop)."""

    def __init__(self, cfg: C.Config, device, dataset: Optional[Dataset] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dataset = dataset if dataset is not None else make_dataset(cfg.data)
        if self.dataset.num_input_channels != (
                9 if cfg.model.family == "shiftinv_vel" else 6):
            raise ValueError(f"model family {cfg.model.family!r} does not "
                             f"take {self.dataset.num_input_channels} input "
                             "channels (the velocity task needs shiftinv_vel)")
        self.box = self.dataset.box
        self.model = build_model(cfg.model, box=self.box, device=self.device)
        self.optimizer = make_optimizer(self.model, cfg.train.learn_rate)
        self.train_step = make_train_step(self.model, self.optimizer)
        self.eval_step = make_eval_step(self.model)
        self.num_inputs = self.dataset.num_input_channels
        self.metrics_log: list[dict] = []
        self.train_error_history: list[float] = []
        self._cov_confirmed = False

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def check_graph_coverage(self, x_in: torch.Tensor) -> int:
        """Edges the lattice window would drop on this batch (0 == covered);
        a nonzero count is printed and logged."""
        v = coverage_violations(self.cfg.model, self.box, x_in)
        if v:
            print(f"graph coverage violated: {v} rows have neighbors outside "
                  f"the lattice window (knn_window={self.cfg.model.knn_window})",
                  flush=True)
            self.metrics_log.append({"graph_coverage_violations": int(v)})
        return v

    def _refuse_uncovered(self, x_in: torch.Tensor):
        v = self.check_graph_coverage(x_in)
        if v:
            raise CoverageError(
                f"{v} rows fall outside what knn_window="
                f"{self.cfg.model.knn_window} can represent; increase it")

    def _log_effective_impl(self, verbose: bool):
        """Record the neighbor route the model's forward took."""
        rec = dict(self.model.impl_record)
        self.metrics_log.append({"effective_neighbor_impl": rec})
        if verbose:
            print(f"effective neighbor route: {rec}", flush=True)

    def _monitor_coverage(self, x_in: torch.Tensor, rec: dict):
        """O(N) margin monitor folded into a checkpoint record; a nonzero
        margin count triggers one exact check per violation episode."""
        pos = x_in[..., :3] + self.box / 2.0 + x_in[..., 3:6]
        cv = int(lattice_violations(pos, self.dataset.cells, box=self.box,
                                    window=self.cfg.model.knn_window))
        rec["coverage_margin_violations"] = cv
        if cv == 0:
            self._cov_confirmed = False     # re-arm for a later episode
        elif not self._cov_confirmed:
            self._cov_confirmed = True
            self._refuse_uncovered(x_in)   # raises unless the exact check is 0
            rec["graph_coverage_violations"] = 0

    def fit(self, num_iters: Optional[int] = None,
            rng: Optional[np.random.Generator] = None,
            verbose: bool = True) -> float:
        """Train loop (reference train.py:87-120).  Returns the last loss."""
        tcfg = self.cfg.train
        num_iters = num_iters if num_iters is not None else tcfg.num_iters
        rng = rng if rng is not None else self.dataset.minibatch_rng()
        self.model.train()
        loss = None
        t0 = time.time()
        for it in range(num_iters):
            batch = self.dataset.get_minibatch(rng, tcfg.batch_size)
            x_in, y_true = split_batch(self._put(batch), self.num_inputs)
            if it == 0:
                self._refuse_uncovered(x_in)
            loss = self.train_step(x_in, y_true)
            if it == 0:
                self._log_effective_impl(verbose)
            if (it + 1) % tcfg.checkpoint_every == 0:
                last = float(loss)
                rec = {"step": it + 1, "loss": last,
                       "elapsed_s": time.time() - t0}
                self._monitor_coverage(x_in, rec)
                self.metrics_log.append(rec)
                self.train_error_history.append(last)
                if verbose:
                    print(f"Checkpoint {it + 1:>5} : {last:.6f}")
        return float(loss) if loss is not None else float("nan")

    def evaluate(self, split: str = "test", verbose: bool = True):
        """Sequential eval sweep (reference train.py:140-174).  Returns
        (per-batch errors, predictions cube (2, n, N, 3), or (2, n, N, 6)
        for the velocity task): slot 0 is the ground truth, slot 1 the
        prediction."""
        bsize = self.cfg.train.batch_size
        x_split = {"val": self.dataset.X_val, "test": self.dataset.X_test}[split]
        n = (x_split.shape[0] // bsize) * bsize
        if n == 0:
            raise ValueError(
                f"{split} split has {x_split.shape[0]} samples — fewer than "
                f"batch_size={bsize}; lower -b or raise the split size")
        self.model.eval()
        errors = []
        preds = None
        for p, batch in self.dataset.sequential_batches(split, bsize):
            x_in, y_true = split_batch(self._put(batch), self.num_inputs)
            pred, err = self.eval_step(x_in, y_true)
            if preds is None:
                preds = np.zeros((2, n, self.dataset.num_particles,
                                  pred.shape[-1]), np.float32)
            preds[0, p:p + bsize] = y_true.cpu().numpy()
            preds[1, p:p + bsize] = pred.cpu().numpy()
            errors.append(float(err))
            if verbose:
                print(f"val_err, {p // bsize} : {errors[-1]}")
        return np.asarray(errors, np.float32), preds
