"""Training loop (port of nbody_tpu/train/trainer.py; reference
train.py:84-182).

One step rebuilds the kNN graph (one fused CUDA kernel), runs forward
and backward through the CUDA gather / scatter kernels, and applies Adam
(``torch.optim.Adam`` with optax.adam's betas and eps; the update formulas
agree).  PyTorch runs eagerly, so the step is a plain function.  The
device is explicit.

``fit`` runs one eager step at a time.  ``fit_scan`` is the JAX
trainer's path for long runs: chunks of T steps, each step one replay of
a CUDA graph of the whole step (``TrainScan``, the Hopper form of
lax.scan), over batches staged on the device a chunk at a time or sliced
from a device-resident training set (``device_data``); the host reads
the losses once a chunk.  For the same minibatch generator both give the
same losses.

Coverage guard: the JAX trainer only warns when the lattice window cannot
represent the data; the port refuses, as bench.py:192-199 does.  The exact
check runs on the first batch of every ``fit`` / ``fit_scan``, and the
O(N) margin monitor at every checkpoint (every chunk of ``fit_scan``)
triggers one exact check per episode of margin violations; both run
outside the graph, and neither runs for the families without a kNN
graph (set, attn).  The monitor watches the lattice window, so it runs
only where the graph comes from the lattice search: knn_method "lattice"
on a full cells^3 cube (trainer.py:279-282).  A step with ``remat``
recomputes each layer in the backward pass, and fit_scan captures it
like any other step.  Evaluation runs the model's
``eval_fn`` (attn: frozen batch-norm statistics).  After the first step
the model's effective neighbor route (``impl_record``: direct, block, or
masked with its core and mask dtype, index, int8 or int4) is printed and
logged, as _log_effective_impl does in JAX.  With a Saver, every record
also goes to metrics.jsonl and a checkpoint labelled with the global
step is saved every ``checkpoint_every`` steps of ``fit`` and after
every chunk of ``fit_scan``.  Sharded and ensemble training are not ported yet
(ROADMAP.md).

Tracing (tracing.py): the train step marks ``start``, ``loss``,
``backward`` and ``adam`` (the model marks ``knn``, ``plan``,
``features`` and probes each layer) into a step timeline, open always
while TrainScan captures the step's graph and on an eager step while a
profiler records.  fit_scan reads the timeline of each chunk's last step
at the chunk's loss read and logs it as ``device_ms``; while a profiler
records it also samples it with the chunk's counter deltas, and spans
name the chunk's staging, steps and loss read, the coverage checks and
the graph's warm step and capture.  ``elapsed_s`` is on the monotonic
``time.perf_counter()`` clock.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.data.dataset import Dataset, make_dataset, split_batch
from nbody_tpu_torch.models.registry import build_model, coverage_violations
from nbody_tpu_torch.ops.knn import lattice_violations
from nbody_tpu_torch.physics.losses import loss_za


class CoverageError(RuntimeError):
    """The lattice kNN window drops edges on this data: the model would
    train on a silently corrupted graph."""


def make_optimizer(model: torch.nn.Module, learn_rate: float) -> torch.optim.Adam:
    """optax.adam(lr) counterpart: b1 0.9, b2 0.999, eps 1e-8.  On the card
    the update is ``capturable`` (its step count stays on the device, with
    no host sync), so that a CUDA graph can hold the whole train step;
    fit and fit_scan run the same update.  ``capturable`` needs CUDA
    tensors, so on the CPU it stays off."""
    cuda = next(model.parameters()).is_cuda
    return torch.optim.Adam(model.parameters(), lr=learn_rate,
                            betas=(0.9, 0.999), eps=1e-8, capturable=cuda)


class TrainStep:
    """(x_in, y_true) -> loss (a device scalar; reading it synchronizes).
    The step opens a step timeline (tracing.timeline: always with
    ``capture``, else while a profiler records) and marks ``start``,
    ``loss``, ``backward`` after loss.backward() returns and ``adam``
    after the update; ``timeline`` is the last call's, or None."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, loss_fn: Callable = loss_za):
        self.model, self.optimizer, self.loss_fn = model, optimizer, loss_fn
        self.timeline: Optional[tracing.Timeline] = None

    def __call__(self, x_in: torch.Tensor, y_true: torch.Tensor,
                 capture: bool = False) -> torch.Tensor:
        with tracing.timeline(x_in.device, always=capture) as tl:
            tracing.mark("start")
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss_fn(self.model(x_in), y_true)
            tracing.mark("loss")
            loss.backward()
            tracing.mark("backward")
            self.optimizer.step()
            tracing.mark("adam")
        self.timeline = tl
        return loss.detach()


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = loss_za) -> TrainStep:
    """(x_in, y_true) -> loss (a device scalar; reading it synchronizes)."""
    return TrainStep(model, optimizer, loss_fn)


def make_eval_step(model: torch.nn.Module, loss_fn: Callable = loss_za):
    """(x_in, y_true) -> (pred, loss) by the model's eval-mode forward
    (``eval_fn``), without gradients."""

    @torch.no_grad()
    def step(x_in: torch.Tensor, y_true: torch.Tensor):
        pred = model.eval_fn(x_in)
        return pred, loss_fn(pred, y_true)

    return step


@dataclasses.dataclass
class _Slot:
    """One batch shape's static input, its views, and its graph."""
    batch: torch.Tensor
    x_in: torch.Tensor
    y_true: torch.Tensor
    warm: bool = False
    graph: Optional["torch.cuda.CUDAGraph"] = None
    loss: Optional[torch.Tensor] = None
    timeline: Optional[tracing.Timeline] = None
    # what the capture counted (tracing.py), added at every replay
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class TrainScan:
    """T train steps a call over batches that stay on the device, their
    losses gathered into a (T,) device tensor: the port of
    make_train_scan (``run``: a (T, b, N, C) block of batches) and
    make_train_scan_device (``run_indexed``: a device-resident training
    set and a (T, b) block of minibatch indices).

    Before each step one device-to-device copy fills a static batch
    buffer.  On the card the step is one CUDA graph per batch shape,
    replayed once a step (the Hopper form of lax.scan over the step, and
    one graph for every chunk length).  The first step a graph serves
    runs eagerly on a side stream: it creates Adam's state and the .grad
    tensors, and it is a step of the sequence.  The capture follows at
    the next step; it records and executes nothing, so every replay after
    it is a step of the sequence and no extra optimizer step enters the
    trajectory.  The kernel wrappers launch on the current stream, so the
    capture records them.  The capture records the step's timeline too,
    and its counters' change is taken back and added at every replay
    instead (``graph.captures``, ``graph.replays``): the counters count
    what the card ran.  ``timeline`` is the last step's.  On the CPU the
    same step runs eagerly, T times a call."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: Callable = loss_za):
        self.optimizer = optimizer
        self.step = make_train_step(model, optimizer, loss_fn)
        self._slots: Dict[tuple, _Slot] = {}
        self.timeline: Optional[tracing.Timeline] = None

    def reset(self):
        """Drop the graphs (after the optimizer's state tensors were
        replaced, e.g. by a restore)."""
        self._slots.clear()

    def run(self, batches: torch.Tensor, num_inputs: int) -> torch.Tensor:
        """batches (T, b, N, C) on the device -> losses (T,)."""
        return self._run(batches.shape[0], lambda i, out: out.copy_(batches[i]),
                         batches.shape[1:], num_inputs, batches.device)

    def run_indexed(self, x_all: torch.Tensor, idxs: torch.Tensor,
                    num_inputs: int) -> torch.Tensor:
        """x_all (S, N, C) and idxs (T, b) int64 on the device -> losses
        (T,); step t trains on x_all[idxs[t]]."""
        return self._run(
            idxs.shape[0],
            lambda i, out: torch.index_select(x_all, 0, idxs[i], out=out),
            (idxs.shape[1],) + tuple(x_all.shape[1:]), num_inputs, x_all.device)

    def _run(self, t: int, fill, shape, num_inputs: int, device) -> torch.Tensor:
        slot = self._slot(tuple(shape), num_inputs, device)
        losses = torch.empty(t, dtype=torch.float32, device=device)
        for i in range(t):
            fill(i, slot.batch)
            losses[i] = self._step(slot)
        return losses

    def _slot(self, shape: tuple, num_inputs: int, device) -> _Slot:
        key = (shape, num_inputs, str(device))
        slot = self._slots.get(key)
        if slot is None:
            batch = torch.empty(shape, dtype=torch.float32, device=device)
            slot = _Slot(batch, *split_batch(batch, num_inputs))
            self._slots[key] = slot
        return slot

    def _step(self, s: _Slot) -> torch.Tensor:
        if s.batch.device.type != "cuda":
            loss = self.step(s.x_in, s.y_true)
            self.timeline = self.step.timeline
            return loss
        if s.graph is None:
            if not s.warm:
                s.warm = True
                with tracing.span("train_scan.warm_step"):
                    loss = self._side_stream_step(s)
                self.timeline = self.step.timeline
                return loss
            self._capture(s)
        s.graph.replay()
        tracing.add(s.counts)
        tracing.count("graph.replays")
        self.timeline = s.timeline
        return s.loss

    def _side_stream_step(self, s: _Slot) -> torch.Tensor:
        dev = s.batch.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            loss = self.step(s.x_in, s.y_true)
        main.wait_stream(side)
        return loss

    def _capture(self, s: _Slot):
        before = tracing.counters()
        with tracing.span("train_scan.capture"):
            # the graph's backward allocates the .grad tensors in its own pool
            self.optimizer.zero_grad(set_to_none=True)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                s.loss = self.step(s.x_in, s.y_true, capture=True)
        s.timeline = self.step.timeline
        s.counts = tracing.delta(before)
        tracing.restore(before)         # the capture ran nothing on the card
        tracing.count("graph.captures")
        s.graph = graph


class Trainer:
    """End-to-end orchestration (the reference train.py loop).  ``step`` is
    the global step (the JAX TrainState.step): it counts every optimizer
    step of this trainer's fit / fit_scan, and a restore sets it."""

    def __init__(self, cfg: C.Config, device, dataset: Optional[Dataset] = None,
                 saver=None):
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
        self.train_scan = TrainScan(self.model, self.optimizer)
        self.eval_step = make_eval_step(self.model)
        self.saver = saver
        self.step = 0
        self.num_inputs = self.dataset.num_input_channels
        self.metrics_log: list[dict] = []
        self.train_error_history: list[float] = []
        self._graph = cfg.model.family not in C.GRAPHLESS_FAMILIES
        cells = self.dataset.cells
        self._monitored = (self._graph and cfg.model.knn_method == "lattice"
                           and self.dataset.num_particles == cells ** 3)
        self._cov_confirmed = False
        self._x_dev: Optional[torch.Tensor] = None

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _log(self, rec: dict):
        self.metrics_log.append(rec)
        if self.saver is not None:
            self.saver.append_metrics(rec)

    def _checkpoint(self):
        if self.saver is not None:
            self.saver.save_checkpoint(self, self.step)

    @staticmethod
    def _sample(rec: dict, timeline: Optional[tracing.Timeline], steps: int,
                before: Dict[str, int]):
        """The last step's timeline into a checkpoint record (``device_ms``)
        and, while a profiler records, into tracing's samples with the
        counters' change since `before`.  The host has synchronized."""
        device_ms = timeline.segments_ms() if timeline is not None else None
        if device_ms:
            rec["device_ms"] = device_ms
        tracing.sample(steps, device_ms, before)

    def state_dict(self) -> dict:
        """What a checkpoint holds: the model's and the optimizer's state
        and the global step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict):
        """Restore state_dict() in place.  The optimizer keeps its own
        ``capturable`` setting (a checkpoint may come from the other
        device), and the captured graphs, which point at the replaced Adam
        state, are dropped."""
        opt = state["optimizer"]
        opt = {**opt, "param_groups": [
            {**saved, "capturable": group["capturable"]}
            for saved, group in zip(opt["param_groups"],
                                    self.optimizer.param_groups)]}
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])
        self.train_scan.reset()

    def check_graph_coverage(self, x_in: torch.Tensor) -> int:
        """Edges the lattice window would drop on this batch (0 == covered);
        a nonzero count is printed and logged."""
        with tracing.span("coverage.exact"):
            v = coverage_violations(self.cfg.model, self.box, x_in)
        if v:
            m = self.cfg.model
            print(f"graph coverage violated: {v} rows or edges fall outside "
                  f"what knn_method={m.knn_method!r} (knn_window="
                  f"{m.knn_window}, band={m.band!r}) can represent", flush=True)
            self._log({"graph_coverage_violations": int(v)})
        return v

    def _refuse_uncovered(self, x_in: torch.Tensor):
        if not self._graph:
            return
        v = self.check_graph_coverage(x_in)
        if v:
            m = self.cfg.model
            raise CoverageError(
                f"{v} rows or edges fall outside what knn_method="
                f"{m.knn_method!r} (knn_window={m.knn_window}, band={m.band!r}) "
                "can represent; increase the window or the band, or use "
                "knn_method='exact'")

    def _log_effective_impl(self, verbose: bool):
        """Record the neighbor route the model's forward took."""
        rec = dict(self.model.impl_record)
        self._log({"effective_neighbor_impl": rec})
        if verbose:
            print(f"effective neighbor route: {rec}", flush=True)

    def _monitor_coverage(self, x_in: torch.Tensor, rec: dict):
        """O(N) margin monitor folded into a checkpoint record; a nonzero
        margin count triggers one exact check per violation episode."""
        if not self._monitored:
            return
        with tracing.span("coverage.monitor"):
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
        t0 = time.perf_counter()
        before = tracing.counters()
        for it in range(num_iters):
            batch = self.dataset.get_minibatch(rng, tcfg.batch_size)
            x_in, y_true = split_batch(self._put(batch), self.num_inputs)
            if it == 0:
                self._refuse_uncovered(x_in)
            loss = self.train_step(x_in, y_true)
            self.step += 1
            if it == 0:
                self._log_effective_impl(verbose)
            if (it + 1) % tcfg.checkpoint_every == 0:
                last = float(loss)
                rec = {"step": it + 1, "loss": last,
                       "elapsed_s": time.perf_counter() - t0}
                self._sample(rec, self.train_step.timeline,
                             tcfg.checkpoint_every, before)
                before = tracing.counters()
                self._monitor_coverage(x_in, rec)
                self._log(rec)
                self.train_error_history.append(last)
                if verbose:
                    print(f"Checkpoint {it + 1:>5} : {last:.6f}")
                # labelled with the global step: a restored run continues
                # the numbering instead of overwriting
                self._checkpoint()
        return float(loss) if loss is not None else float("nan")

    def _device_data_enabled(self) -> bool:
        """Whether fit_scan keeps X_train on the device: "on", or "auto"
        while X_train fits NBODY_DEVICE_DATA_CAP_GB (default 6 GiB), as
        in JAX (the port has no mesh, so no sharded exception)."""
        mode = self.cfg.train.device_data
        if mode == "off":
            return False
        if mode == "on":
            return True
        cap_gb = float(os.environ.get("NBODY_DEVICE_DATA_CAP_GB", "6"))
        return self.dataset.X_train.nbytes <= cap_gb * 2 ** 30

    def fit_scan(self, num_iters: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None,
                 scan_chunk: int = 50, verbose: bool = True) -> float:
        """Train in chunks of `scan_chunk` steps through ``train_scan``: the
        same minibatch sequence as fit() from the same generator, and the
        same losses; one host read of the losses, one record and one
        checkpoint a chunk.  With device_data the training set is copied
        to the device once and a chunk ships a (T, b) int64 index block,
        else one (T, b, N, C) block of batches.  Returns the last loss."""
        tcfg = self.cfg.train
        num_iters = num_iters if num_iters is not None else tcfg.num_iters
        rng = rng if rng is not None else self.dataset.minibatch_rng()
        if scan_chunk < 1:
            raise ValueError(f"scan_chunk must be positive, got {scan_chunk}")
        use_dev = self._device_data_enabled()
        if use_dev and self._x_dev is None:
            self._x_dev = self._put(self.dataset.X_train)
        self.model.train()
        ni = self.num_inputs
        last = float("nan")
        t0 = time.perf_counter()
        done = 0
        while done < num_iters:
            before = tracing.counters()
            t = min(scan_chunk, num_iters - done)
            with tracing.span("fit_scan.stage"):
                idxs = np.stack([self.dataset.get_minibatch_indices(
                    rng, tcfg.batch_size) for _ in range(t)])
                if use_dev:
                    idx_dev = self._put(idxs)
                    ends = [self._x_dev[idx_dev[j]][..., :ni] for j in (0, -1)]
                else:
                    batches = self._put(self.dataset.X_train[idxs])
                    ends = [batches[j][..., :ni] for j in (0, -1)]
            if done == 0:
                self._refuse_uncovered(ends[0])
            with tracing.span("fit_scan.steps"):
                if use_dev:
                    losses = self.train_scan.run_indexed(self._x_dev, idx_dev, ni)
                else:
                    losses = self.train_scan.run(batches, ni)
            if done == 0:
                self._log_effective_impl(verbose)
            done += t
            self.step += t
            with tracing.span("fit_scan.read_losses"):
                last = float(losses[-1])
                rec = {"step": done, "loss": last,
                       "elapsed_s": time.perf_counter() - t0}
                self._sample(rec, self.train_scan.timeline, t, before)
            self._monitor_coverage(ends[1], rec)
            self._log(rec)
            self.train_error_history.append(last)
            if verbose:
                print(f"Checkpoint {done:>5} : {last:.6f}")
            self._checkpoint()
        return last

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
