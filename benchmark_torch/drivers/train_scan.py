"""Driver of the traffic kind "train_scan": the program's training run
under ``Trainer.fit_scan``, the way ``cli/train --scan T`` runs it.

Set-up (counted in ``setup_s``): the traffic's cubes from the seed
(yardstick/synthetic.py), in one amplitude class a batch slot (the
traffic's ``za_rms`` list: cube s has the amplitude of class s mod its
length); one Trainer with the training set on the card (``device_data``
"on") and a Saver that writes its checkpoints into a temporary
directory; the seeded weights (yardstick/weights.py), the last layer's
scaled so that the reference's prediction on the first training cube has
the traffic's ``pred_rms`` (small against the targets, as a
zero-initialised last layer is: a cube's loss and gradient then grow
with its amplitude), copied into the model; then the first three
optimizer steps through fit_scan in chunks of one step (the eager step
that creates Adam's state, the capture of the step's CUDA graph, a
replay), and one chunk of the window's length.  The minibatches come
from a seeded feed that puts one cube of a different class in each slot
of a batch (every epoch a new order), so that the first three steps
train on rows that all differ, and a batch's cubes weigh 1 : 3 : 9 : 27
in its loss: a step on any half of it reads a loss 40 % or more off.

The window: the same fit_scan call goes on, chunk after chunk, until
``--seconds`` have passed at a chunk's end; particle-steps per second are
all the steps the window completed times the particles of a batch, over
the window's time on the host clock (each chunk ends with the host's
read of its losses, which waits for the card).  Each chunk also runs the
trainer's margin monitor and writes its metrics record and checkpoint.
With ``--trace 1`` a profiler covers the traffic's ``trace_chunks``
chunks instead.

The check (after the window): the program's kNN ids of the first batch
(its ``knn_fn``, kernel A, the graph its step builds); then, the
program's state freed, the plain reference runs the same three steps on
the same rows from the same weights, on the benchmark's own features of
the raw cubes (yardstick/features.py), and compare.train_checks sets the
program's ids, losses, first gradient (Adam's first moment after step 1
over 1 - b1) and parameter change after step 3 beside its.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time

import numpy as np

from benchmark_torch import compare
from benchmark_torch.harness import Result, Run, TraceView, derive_seed, profiler, reduce_profile
from benchmark_torch.reference import common
from benchmark_torch.yardstick import features
from benchmark_torch.yardstick.synthetic import synthetic_raw_cubes
from benchmark_torch.yardstick.weights import make_layers

BETA1 = 0.9
# the split the Trainer's Dataset is given: one test and one validation cube
NUM_TEST = NUM_VAL = 1


class EpochFeed:
    """The minibatch indices of the run: ``choice(n, size, replace=False)``
    as Dataset.get_minibatch_indices calls it.  A batch takes one row of
    each of `size` classes, the classes in a seeded order and each class's
    rows in a seeded permutation, drawn anew once any class is used up;
    every batch is recorded."""

    def __init__(self, seed: int, classes: np.ndarray):
        self.rng = np.random.default_rng(seed)
        self.classes = np.asarray(classes)
        self.labels = np.unique(self.classes)
        self.queues = {}
        self.batches = []

    def choice(self, n: int, size: int, replace: bool = False):
        if replace or n != self.classes.size or size > self.labels.size:
            raise ValueError(f"the feed draws {size} distinct rows of {n}, one a "
                             f"class of {self.labels.size}")
        if not self.queues or min(len(q) for q in self.queues.values()) == 0:
            self.queues = {c: list(self.rng.permutation(np.flatnonzero(self.classes == c)))
                           for c in self.labels}
        batch = np.array([self.queues[c].pop()
                          for c in self.rng.permutation(self.labels)[:size]])
        self.batches.append(batch)
        return batch


class StopWindow(Exception):
    """Raised at a chunk's end to end the window."""


class ChunkHook:
    """The trainer's Saver: writes each checkpoint through the real one,
    then hands the chunk's end to `on_chunk` (which may end the run by
    raising StopWindow)."""

    def __init__(self, saver, on_chunk):
        self.saver, self.on_chunk = saver, on_chunk

    def save_checkpoint(self, trainer, step):
        from torch.profiler import record_function
        with record_function("bench: Saver.save_checkpoint"):
            path = self.saver.save_checkpoint(trainer, step)
        self.on_chunk(trainer)
        return path

    def append_metrics(self, rec):
        from torch.profiler import record_function
        with record_function("bench: Saver.append_metrics"):
            self.saver.append_metrics(rec)


def _allocated(run: Run) -> str:
    import torch
    if run.device.type != "cuda":
        return "cpu"
    return (f"allocated {torch.cuda.memory_allocated(run.device)} B, "
            f"peak {torch.cuda.max_memory_allocated(run.device)} B")


def _leaves(model):
    p = model.params
    return list(p.W) + list(p.B)


def data(run: Run):
    """The cell's cubes, the program's dataset of them, the benchmark's own
    features of its training rows, the feed and the seeded weights, made
    from the seed (nothing of the program runs here but the features and
    the split of its Dataset)."""
    import torch
    from nbody_tpu_torch.data.dataset import Dataset
    cfg, tr = run.cell.config, run.cell.traffic
    amps, total = tr["za_rms"], cfg["num_samples"]
    per = -(-total // len(amps))
    parts = [synthetic_raw_cubes(per, cfg["cells"], seed=derive_seed(run.seed, 10 + c),
                                 za_rms=a) for c, a in enumerate(amps)]
    raw = np.stack(parts, axis=1).reshape((per * len(amps),) + parts[0].shape[1:])[:total]
    del parts
    dataset = Dataset(_config(run, "").data, raw=raw)
    rows = features.train_rows(total, NUM_TEST, NUM_VAL)
    ref_x = features.features(raw[rows])
    feed = EpochFeed(derive_seed(run.seed, 2), rows % len(amps))
    ref = run.cell.reference
    layers = make_layers(cfg["channels"], ref.NUM_WEIGHTS, ref.NUM_BIASES,
                         derive_seed(run.seed, 3), run.device)
    layers = [{"W": l["W"][0], "B": l["B"][0]} for l in layers]
    forward = ref.make_forward(cfg, tr["knn_window"])
    with common.f32_within(), torch.no_grad():
        x0 = torch.as_tensor(ref_x[:1, :, :6], device=run.device)
        pred = forward(layers, x0)
        rms = float(torch.sqrt(torch.mean(torch.sum(pred.double() ** 2, dim=-1))))
    layers[-1]["W"] = layers[-1]["W"] * (tr["pred_rms"] / rms)
    run.log(f"{total} cubes made; last layer scaled by {tr['pred_rms'] / rms:.4g}")
    return dataset, ref_x, feed, layers


def _config(run: Run, workdir: str):
    from nbody_tpu_torch import config as C
    cfg, tr = run.cell.config, run.cell.traffic
    return C.Config(
        data=C.DataConfig(num_test=NUM_TEST, num_val=NUM_VAL, cells_per_side=cfg["cells"],
                          synthetic_num_samples=cfg["num_samples"]),
        model=C.ModelConfig(family=cfg["family"], channels=tuple(cfg["channels"]),
                            k_neighbors=cfg["k_neighbors"], dtype=cfg["dtype"],
                            knn_window=tr["knn_window"],
                            mask_dtype=tr.get("mask_dtype", "auto")),
        train=C.TrainConfig(batch_size=tr["batch"], learn_rate=cfg["learn_rate"],
                            scan_chunk=tr["scan_chunk"], device_data="on",
                            experiments_dir=workdir, name="bench"))


def build(run: Run, workdir: str):
    """The trainer, its hook, its feed, its dataset, the reference's
    training rows and the seeded weights."""
    import torch
    from nbody_tpu_torch.io_.saver import Saver
    from nbody_tpu_torch.train.trainer import Trainer

    dataset, ref_x, feed, layers = data(run)
    hook = ChunkHook(Saver(0, model_tag="bench", experiments_dir=workdir), None)
    trainer = Trainer(_config(run, workdir), run.device, dataset=dataset, saver=hook)
    with torch.no_grad():
        for p, v in zip(_leaves(trainer.model),
                        [l["W"] for l in layers] + [l["B"] for l in layers]):
            p.copy_(v)
    if run.tamper is not None:
        run.tamper(trainer, feed)
    run.log(f"trainer built; {_allocated(run)}")
    return trainer, hook, feed, dataset, ref_x, layers


def first_steps(trainer, hook, feed, run: Run) -> dict:
    """Steps 1-3 through fit_scan in chunks of one step: the losses, the
    first gradient as Adam got it and the change after step 3."""
    import torch
    leaves = _leaves(trainer.model)
    start = [p.detach().clone() for p in leaves]
    got = {"losses": []}

    def on_chunk(tr):
        got["losses"].append(tr.metrics_log[-1]["loss"])
        if tr.step == 1:
            state = tr.optimizer.state
            got["grads"] = [state[p]["exp_avg"].detach() / (1.0 - BETA1)
                            if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                            for p in leaves]
        if tr.step == 3:
            got["deltas"] = [p.detach() - p0 for p, p0 in zip(leaves, start)]

    hook.on_chunk = on_chunk
    trainer.fit_scan(num_iters=3, rng=feed, scan_chunk=1, verbose=False)
    return got


def window(trainer, hook, feed, run: Run):
    """Chunks of fit_scan until the window closes -> (steps, seconds,
    failed steps, profiler or None, set-up end)."""
    import torch
    tr = run.cell.traffic
    chunk = tr["scan_chunk"]
    st = {"t": [], "steps": [], "failed": 0, "prof": None}

    def on_chunk(t):
        now = time.perf_counter()
        if not st["t"]:                       # the warm-up chunk ends set-up
            st["t"].append(now)
            st["steps"].append(t.step)
            run.spans.append(("setup", run.t0, now))
            if run.trace:
                st["prof"] = profiler()
                st["prof"].start()
                st["t"][0] = time.perf_counter()
            return
        run.spans.append(("chunk", st["t"][-1], now))
        st["t"].append(now)
        st["steps"].append(t.step)
        if not math.isfinite(t.metrics_log[-1]["loss"]):
            st["failed"] += chunk
        done = len(st["t"]) - 1
        if (run.trace and done >= tr["trace_chunks"]) or (
                not run.trace and now - st["t"][0] >= run.seconds):
            if st["prof"] is not None:
                torch.cuda.synchronize(run.device)
                st["prof"].stop()
            raise StopWindow

    hook.on_chunk = on_chunk
    try:
        trainer.fit_scan(num_iters=10 ** 9, rng=feed, scan_chunk=chunk,
                         verbose=False)
    except StopWindow:
        pass
    return (st["steps"][-1] - st["steps"][0], st["t"][-1] - st["t"][0],
            st["failed"], st["prof"], st["t"][0])


def program_knn(trainer, dataset, feed, run: Run):
    """The program's kNN ids of the first batch, by the model's own
    knn_fn on its own features of the batch (what its step searches)."""
    import torch
    x = torch.as_tensor(dataset.X_train[feed.batches[0]][..., :6], device=run.device)
    with torch.no_grad():
        return trainer.model.knn_fn(x).cpu()


def reference_steps(run: Run, ref_x, feed, layers, cast=common.identity,
                    batch_keep: float = 1.0) -> dict:
    """The plain reference's first three steps on the rows the program
    trained on, and its kNN ids and positions of the first batch."""
    import torch
    cfg, tr = run.cell.config, run.cell.traffic
    common.strict_f32()
    forward = run.cell.reference.make_forward(cfg, tr["knn_window"])
    batches = []
    for rows in feed.batches[:3]:
        x = torch.as_tensor(ref_x[rows], device=run.device)
        batches.append((x[..., :6], x[..., 6:9]))
    losses, grads, deltas, per_cube = common.train_steps(
        forward, layers, batches, cfg["learn_rate"], cast, batch_keep)
    _, _, pos_norm = common.graph_geometry(batches[0][0], 4.0 * cfg["cells"])
    knn = common.lattice_knn(pos_norm, cfg["k_neighbors"], cfg["cells"], tr["knn_window"])
    return {"losses": losses, "grads": grads, "deltas": deltas,
            "per_cube": per_cube, "knn": knn.cpu(), "pos_norm": pos_norm.cpu()}


def host(rec: dict) -> dict:
    """A record's tensors on the host."""
    import torch
    return {k: ([t.detach().cpu() for t in v] if isinstance(v, list) and v
                and isinstance(v[0], torch.Tensor) else v) for k, v in rec.items()}


def run(run: Run) -> Result:
    import torch
    workdir = tempfile.mkdtemp(prefix="bench_train_")
    try:
        trainer, hook, feed, dataset, ref_x, layers = build(run, workdir)
        prog = first_steps(trainer, hook, feed, run)
        run.log(f"first steps: losses {prog['losses']}; route "
                f"{trainer.model.impl_record}; {_allocated(run)}")
        steps, secs, failed, prof, t_setup = window(trainer, hook, feed, run)
        cuda = run.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
        n = run.cell.config["cells"] ** 3 * run.cell.traffic["batch"]
        run.log(f"window: {steps} steps in {secs:.3f} s; peak {peak} B")
        view = None
        if prof is not None:
            kernels, host_events = reduce_profile(prof)
            view = TraceView(kernels, host_events, steps, secs, run.cell)
        prog = host(prog)
        prog["knn"] = program_knn(trainer, dataset, feed, run)
        del trainer, hook
        if cuda:
            torch.cuda.empty_cache()
        ref = host(reference_steps(run, ref_x, feed, layers))
        run.log(f"reference losses {ref['losses']}")
        checks = compare.train_checks(prog, ref, run.cell.limits)
        e2e = {"setup_s": t_setup - run.t0,
               "train_particle_steps_per_s": steps * n / secs}
        return Result(e2e, steps, failed, checks, peak, view)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
