#!/usr/bin/env python3
"""Drive the PyTorch port (nbody_tpu_torch) once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. find the card; print its name and nvidia-smi's name and power limit;
  2. build the CUDA kernels from nbody_tpu_torch/csrc with nvcc, one nvcc
     per source, all started together;
  3. hold kernels A-C against their plain PyTorch versions on the card, at
     the main path's shapes (32^3 particles, batch 4, K 14, window 2),
     check the two autograd Functions' gradients, and time kernel and
     plain version with CUDA events;
  4. drive the main path through its entry points: Dataset (16 synthetic
     32^3 cubes), Trainer with the coverage guard, 5 bf16 fit steps and
     evaluate on the test split, counting kernel launches; then time the
     train step and read the peak device memory;
  5. one f32 forward + loss of the same params and cube on the card and on
     the CPU (plain versions) must agree to rtol 1e-4;
  6. hold kernels D-G against their plain versions at the 64^3 index
     route's shapes (cores (4,8,8) and (8,8,8)) and the 32^3 block route's,
     for every width the layers give them, D/E in bf16 and F/G in f32 and
     bf16 with fast on and off; check both autograd pairs against the CPU;
     time kernel and plain version;
  7. the 64^3 shiftinv_vel path through its entry points: Dataset with
     velocities (6 synthetic 64^3 cubes), Trainer with the coverage guard
     (the host k-d tree search), 4 bf16 fit steps at batch 1 on
     --mask_dtype index and evaluate, counting launches (D and E run, B
     and C do not); step time and peak memory, also for core (8,8,8);
  8. the --impl block route at 32^3 b4: 3 bf16 fit steps on F and G;
  9. the same params and 32^3 batch through the index route (D/E) and the
     direct route (B/C) in bf16: loss within rtol 3e-2, gradient cosine
     above 0.998.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CELLS, BATCH, K, WINDOW = 32, 4, 14, 2
WIDTHS = (3, 16, 32, 64)          # the layer widths the gather/scatter see
CELLS64 = 64
# widths the block-selection kernels see on shiftinv_vel: counts, the
# payload gather (disp + vel), and the channels 9-32-64-64-32-16-6
SELECT_WIDTHS = (1, 6, 9, 16, 32, 64)
INDEX_CORES = ((4, 8, 8), (8, 8, 8))
BLOCK_SRC = "nbody_tpu_torch/csrc/block_kernels.cu"
REPO_KERNELS = {
    "topk_min": ("nbody_tpu_torch/csrc/topk_kernels.cu",
                 "nbody_tpu/ops/pallas/topk_kernels.py:46"),
    "neighbor_gather": ("nbody_tpu_torch/csrc/banded_kernels.cu",
                        "nbody_tpu/ops/pallas/banded_kernels.py:113"),
    "neighbor_scatter_add": ("nbody_tpu_torch/csrc/banded_kernels.cu",
                             "nbody_tpu/ops/pallas/banded_kernels.py:170"),
    "idx_dot_gather": (BLOCK_SRC, "nbody_tpu/ops/pallas/idx_kernels.py:169"),
    "idx_dot_scatter": (BLOCK_SRC, "nbody_tpu/ops/pallas/idx_kernels.py:179"),
    "block_gather": (BLOCK_SRC, "nbody_tpu/ops/pallas/block_kernels.py:34"),
    "block_scatter": (BLOCK_SRC, "nbody_tpu/ops/pallas/block_kernels.py:67"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (2^-8 at 0)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_kernels(dev, idx, d2_lattice):
    """Kernel vs plain at main-path shapes.  Returns per-kernel records."""
    from nbody_tpu_torch.ops import banded
    from nbody_tpu_torch.ops.kernels import banded_kernels as B
    from nbody_tpu_torch.ops.kernels import topk_kernels as T

    g = torch.Generator(device=dev).manual_seed(0)
    rec = {name: {"max_abs_err": 0.0}
           for name in ("topk_min", "neighbor_gather", "neighbor_scatter_add")}

    # kernel A: bit-equal slots on lattice, random, tied and inf/NaN rows
    rows, m = d2_lattice.shape
    d_rand = torch.rand((rows, m), generator=g, device=dev)
    d_bad = d_rand.clone()
    d_bad[torch.rand((rows, m), generator=g, device=dev) < 0.2] = float("inf")
    d_bad[torch.rand((rows, m), generator=g, device=dev) < 0.2] = float("nan")
    d_bad[:64] = float("inf")
    for label, d in (("lattice", d2_lattice), ("random", d_rand),
                     ("ties", torch.floor(d_rand * 8.0)), ("inf/nan", d_bad)):
        got, want = T.topk_min(d, K), T.topk_min_plain(d, K)
        bad = int((got != want).any(dim=1).sum())
        rec["topk_min"]["max_abs_err"] = max(
            rec["topk_min"]["max_abs_err"], float((got - want).abs().max()))
        print(f"kernel A topk_min {label} ({rows}, {m}) k={K}: "
              f"{bad} rows differ")
        check(bad == 0, f"topk_min {label} rows differ from the plain version")
    # the kernel's second instance (16 < k <= 32)
    check(torch.equal(T.topk_min(d_rand, 32), T.topk_min_plain(d_rand, 32)),
          "topk_min k=32 differs from the plain version")
    print("kernel A topk_min random k=32: bit-equal")
    rec["topk_min"]["ms"] = cuda_ms(lambda: T.topk_min(d2_lattice, K))
    rec["topk_min"]["plain_ms"] = cuda_ms(lambda: T.topk_min_plain(d2_lattice, K))

    # kernels B and C at every main-path width, f32 and bf16
    b, n, k = idx.shape
    for c in WIDTHS:
        for dt in (torch.float32, torch.bfloat16):
            v = torch.randn((b, n, c), generator=g, device=dev).to(dt)
            got, want = B.neighbor_gather(v, idx), B.gather_plain(v, idx)
            rec["neighbor_gather"]["max_abs_err"] = max(
                rec["neighbor_gather"]["max_abs_err"],
                float((got.float() - want.float()).abs().max()))
            check(torch.equal(got, want),
                  f"neighbor_gather C={c} {dt} is not bit-equal")
            e = torch.randn((b, n, k, c), generator=g, device=dev).to(dt)
            got = B.neighbor_scatter_add(e, idx).float()
            want = B.scatter_add_plain(e.float(), idx)      # f32 accumulation
            absum = B.scatter_add_plain(e.float().abs(), idx)
            err = (got - want).abs()
            # f32: rtol 1e-5 of the summed |terms| (atomic order varies);
            # bf16: one bf16 ulp of the f32-accumulated sum, plus that slack
            tol = 1e-5 * absum + (bf16_ulp(want) if dt == torch.bfloat16 else 0)
            worst = float((err - tol).max())
            rec["neighbor_scatter_add"]["max_abs_err"] = max(
                rec["neighbor_scatter_add"]["max_abs_err"], float(err.max()))
            print(f"kernels B/C C={c:>2} {str(dt):>14}: gather bit-equal, "
                  f"scatter max|err| {float(err.max()):.3e} "
                  f"(worst err - tol {worst:.3e})")
            check(worst <= 0, f"neighbor_scatter_add C={c} {dt} out of tolerance")

    # the autograd Functions: each gradient is the other kernel; the card's
    # gradients against the CPU's plain versions
    c = 16
    v = torch.randn((b, n, c), generator=g, device=dev, requires_grad=True)
    ct = torch.randn((b, n, k, c), generator=g, device=dev)
    (gv,) = torch.autograd.grad(banded.neighbor_gather(v, idx), v, ct)
    vc = v.detach().cpu().requires_grad_()
    (gvc,) = torch.autograd.grad(banded.neighbor_gather(vc, idx.cpu()), vc,
                                 ct.cpu())
    absum = B.scatter_add_plain(ct.abs().cpu(), idx.cpu())
    gerr = float(((gv.cpu() - gvc).abs() - 1e-5 * absum).max())
    e = torch.randn((b, n, k, c), generator=g, device=dev, requires_grad=True)
    ct2 = torch.randn((b, n, c), generator=g, device=dev)
    (ge,) = torch.autograd.grad(banded.neighbor_scatter_add(e, idx), e, ct2)
    ec = e.detach().cpu().requires_grad_()
    (gec,) = torch.autograd.grad(banded.neighbor_scatter_add(ec, idx.cpu()),
                                 ec, ct2.cpu())
    print(f"autograd: gather grad (scatter kernel) worst err - tol {gerr:.3e}; "
          f"scatter grad (gather kernel) bit-equal {torch.equal(ge.cpu(), gec)}")
    check(gerr <= 0 and torch.equal(ge.cpu(), gec), "gradients disagree")

    c = 64
    v = torch.randn((b, n, c), generator=g, device=dev).to(torch.bfloat16)
    e = torch.randn((b, n, k, c), generator=g, device=dev).to(torch.bfloat16)
    rec["neighbor_gather"]["ms"] = cuda_ms(lambda: B.neighbor_gather(v, idx))
    rec["neighbor_gather"]["plain_ms"] = cuda_ms(lambda: B.gather_plain(v, idx))
    rec["neighbor_scatter_add"]["ms"] = cuda_ms(
        lambda: B.neighbor_scatter_add(e, idx))
    rec["neighbor_scatter_add"]["plain_ms"] = cuda_ms(
        lambda: B.scatter_add_plain(e, idx))
    for name, r in rec.items():
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              + ("" if name == "topk_min" else f" (C={c} bf16)"))
    return rec


def scatter_worst(got, want, absum, bf16_out):
    """(max |err|, max(|err| - tol)) of a scatter: f32 sums within 1e-5 of
    the summed |terms| (the order of the atomic adds varies); a bf16
    result one bf16 ulp more."""
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * absum + (bf16_ulp(want) if bf16_out else 0)
    return float(err.max()), float((err - tol).max())


def check_select_kernels(dev, idx64, idx32):
    """Kernels D-G against their plain versions at the 64^3 index route's
    and the 32^3 block route's shapes, both autograd pairs against the
    CPU, and times.  Returns per-kernel records."""
    from nbody_tpu_torch.ops import banded, blocked
    from nbody_tpu_torch.ops.kernels import block_kernels as BK
    from nbody_tpu_torch.ops.kernels import idx_kernels as IK

    g = torch.Generator(device=dev).manual_seed(1)
    rec = {n: {"max_abs_err": 0.0}
           for n in ("idx_dot_gather", "idx_dot_scatter", "block_gather",
                     "block_scatter")}

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def note(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    bf = torch.bfloat16
    pos_by_core = {}
    for core in INDEX_CORES:
        pos = blocked.block_positions(idx64, CELLS64, WINDOW, core,
                                      drop_self_slot0=True)
        p = blocked.patch_size(CELLS64, WINDOW, core)
        pos_by_core[core] = (pos, p)
        _, nb, et = pos.shape
        for c in SELECT_WIDTHS:
            pat = randn((1, nb, p, c), bf)
            got, want = IK.dot_gather(pos, pat), IK.dot_gather_plain(pos, pat)
            note("idx_dot_gather", float((got.float() - want.float()).abs().max()))
            check(torch.equal(got, want), f"idx_dot_gather {core} C={c} not bit-equal")
            ev = randn((1, nb, et, c), bf)
            err, worst = scatter_worst(
                IK.dot_scatter(pos, ev, p), IK.dot_scatter_plain(pos, ev, p),
                IK.dot_scatter_plain(pos, ev.abs(), p), False)
            note("idx_dot_scatter", err)
            print(f"kernels D/E core {core} (1, {nb}, {et}) P={p} C={c:>2}: "
                  f"gather bit-equal, scatter max|err| {err:.3e} "
                  f"(worst err - tol {worst:.3e})")
            check(worst <= 0, f"idx_dot_scatter {core} C={c} out of tolerance")

    p32 = blocked.edge_block_positions(idx32, CELLS, WINDOW, blocked.CORE)
    pp32 = blocked.patch_size(CELLS, WINDOW, blocked.CORE)
    b, nb, et = p32.shape
    for c in SELECT_WIDTHS:
        for dt in (torch.float32, bf):
            for fast in (True, False):
                pat = randn((b, nb, pp32, c), torch.float32).to(dt)
                got = BK.block_gather(p32, pat, fast)
                want = BK.block_gather_plain(p32, pat, fast)
                note("block_gather", float((got - want).abs().max()))
                check(torch.equal(got, want),
                      f"block_gather C={c} {dt} fast={fast} not bit-equal")
                ev = randn((b, nb, et, c), torch.float32).to(dt)
                err, worst = scatter_worst(
                    BK.block_scatter(p32, ev, pp32, fast),
                    BK.block_scatter_plain(p32, ev, pp32, fast),
                    BK.block_scatter_plain(p32, ev.abs(), pp32, fast), False)
                note("block_scatter", err)
                check(worst <= 0, f"block_scatter C={c} {dt} fast={fast} "
                                  "out of tolerance")
        print(f"kernels F/G (4, {nb}, {et}) P={pp32} C={c:>2}: gathers "
              f"bit-equal, scatters within tolerance (f32/bf16 x fast on/off)")

    # autograd pairs, card against the CPU's plain versions
    pos, p = pos_by_core[INDEX_CORES[0]]
    _, nb, et = pos.shape
    pat = randn((1, nb, p, 16), bf).requires_grad_()
    ct = randn((1, nb, et, 16), bf)
    (gp,) = torch.autograd.grad(IK.idx_dot_gather(pos, pat), pat, ct)
    pc = pat.detach().cpu().requires_grad_()
    (gpc,) = torch.autograd.grad(IK.idx_dot_gather(pos.cpu(), pc), pc, ct.cpu())
    _, gworst = scatter_worst(gp.cpu(), gpc, IK.dot_scatter_plain(
        pos.cpu(), ct.abs().cpu(), p), True)
    ev = randn((1, nb, et, 16), bf).requires_grad_()
    ct2 = randn((1, nb, p, 16), torch.float32)
    (ge,) = torch.autograd.grad(IK.idx_dot_scatter(pos, ev, p), ev, ct2)
    ec = ev.detach().cpu().requires_grad_()
    (gec,) = torch.autograd.grad(IK.idx_dot_scatter(pos.cpu(), ec, p), ec,
                                 ct2.cpu())
    print(f"autograd idx pair: gather grad (kernel E) worst err - tol "
          f"{gworst:.3e}; scatter grad (kernel D) bit-equal "
          f"{torch.equal(ge.cpu(), gec)}")
    check(gworst <= 0 and torch.equal(ge.cpu(), gec), "idx pair gradients disagree")
    lat = (CELLS, WINDOW)
    v = randn((BATCH, CELLS ** 3, 16), bf).requires_grad_()
    ct = randn((BATCH, CELLS ** 3, K, 16), bf)
    (gv,) = torch.autograd.grad(banded.neighbor_gather(v, idx32, lat), v, ct)
    vc = v.detach().cpu().requires_grad_()
    (gvc,) = torch.autograd.grad(banded.neighbor_gather(vc, idx32.cpu(), lat),
                                 vc, ct.cpu())
    _, bworst = scatter_worst(gv.cpu(), gvc, banded.neighbor_scatter_add(
        ct.abs().cpu().float(), idx32.cpu()), True)
    e = randn((BATCH, CELLS ** 3, K, 16), bf).requires_grad_()
    ct2 = randn((BATCH, CELLS ** 3, 16), bf)
    (ge,) = torch.autograd.grad(banded.neighbor_scatter_add(e, idx32, lat), e, ct2)
    ec = e.detach().cpu().requires_grad_()
    (gec,) = torch.autograd.grad(banded.neighbor_scatter_add(ec, idx32.cpu(), lat),
                                 ec, ct2.cpu())
    print(f"autograd block pair: gather grad (kernel G) worst err - tol "
          f"{bworst:.3e}; scatter grad (kernel F) bit-equal "
          f"{torch.equal(ge.cpu(), gec)}")
    check(bworst <= 0 and torch.equal(ge.cpu(), gec),
          "block pair gradients disagree")

    # times at the widest layer width: D/E at the default core, F/G with
    # the block route's own setting (bf16, fast)
    c = 64
    pos, p = pos_by_core[INDEX_CORES[0]]
    _, nb, et = pos.shape
    pat, ev = randn((1, nb, p, c), bf), randn((1, nb, et, c), bf)
    times = {
        "idx_dot_gather": (lambda: IK.dot_gather(pos, pat),
                           lambda: IK.dot_gather_plain(pos, pat)),
        "idx_dot_scatter": (lambda: IK.dot_scatter(pos, ev, p),
                            lambda: IK.dot_scatter_plain(pos, ev, p)),
    }
    pat32 = randn((b, p32.shape[1], pp32, c), bf)
    ev32 = randn((b, p32.shape[1], p32.shape[2], c), bf)
    times["block_gather"] = (lambda: BK.block_gather(p32, pat32, True),
                             lambda: BK.block_gather_plain(p32, pat32, True))
    times["block_scatter"] = (lambda: BK.block_scatter(p32, ev32, pp32, True),
                              lambda: BK.block_scatter_plain(p32, ev32, pp32, True))
    for name, (kern, plain) in times.items():
        rec[name]["ms"] = cuda_ms(kern)
        rec[name]["plain_ms"] = cuda_ms(plain)
        where = (f"64^3 core {INDEX_CORES[0]}" if name.startswith("idx")
                 else "32^3 b4 core (4, 4, 8)")
        print(f"time {name}: kernel {rec[name]['ms']:.4f} ms, plain "
              f"{rec[name]['plain_ms']:.4f} ms ({where}, C={c} bf16)")
    return rec


def reset_counts(*modules):
    for m in modules:
        m.LAUNCHES.update(dict.fromkeys(m.LAUNCHES, 0))


def step_time(trainer, x, y, iters, label):
    """CUDA-event step time and peak device memory of trainer's step."""
    dev = x.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: trainer.train_step(x, y), iters=iters, warmup=2)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"train step ({label}, CUDA events, mean of {iters} after 2 "
          f"warm-up): {ms:.3f} ms; peak device memory {peak / 2**20:.1f} MiB")
    return ms, peak


def make_vel64(dev, C):
    """The 64^3 shiftinv_vel index path's Dataset and Trainer."""
    from nbody_tpu_torch.data.dataset import Dataset
    from nbody_tpu_torch.train.trainer import Trainer

    cfg = C.Config(
        data=C.DataConfig(
            data_dir=os.path.join(os.path.sep, "nonexistent-force-synthetic"),
            num_test=1, num_val=1, cells_per_side=CELLS64,
            synthetic_num_samples=6, include_velocity=True),
        model=C.ModelConfig(family="shiftinv_vel",
                            channels=tuple(C.GRAPH_VEL_CHANNELS), k_neighbors=K,
                            dtype="bfloat16", knn_window=WINDOW,
                            mask_dtype="index"),
        train=C.TrainConfig(num_iters=4, batch_size=1, learn_rate=1e-3,
                            checkpoint_every=1))
    t0 = time.perf_counter()
    ds = Dataset(cfg.data)
    print(f"64^3 velocity dataset: {ds.X_train.shape} train, {ds.X_test.shape} "
          f"test ({time.perf_counter() - t0:.1f} s)")
    return ds, Trainer(cfg, dev, dataset=ds)


def run_vel64(dev, ds, trainer, counted):
    """Phase 7: the 64^3 shiftinv_vel index path through Trainer.fit and
    evaluate.  Returns the launch counts of the fit + evaluate."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.models import registry
    from nbody_tpu_torch.train.trainer import Trainer

    x0, _ = split_batch(torch.as_tensor(ds.X_train[:1], device=dev), 9)
    check(CELLS64 ** 3 > registry.EXACT_KNN_MAX_PARTICLES,
          "64^3 does not reach the host coverage search")
    t0 = time.perf_counter()
    cov = trainer.check_graph_coverage(x0)
    print(f"coverage guard, host k-d tree search: {cov} violations "
          f"({time.perf_counter() - t0:.1f} s)")
    check(cov == 0, "the lattice window does not cover the 64^3 data")
    reset_counts(*counted)
    t0 = time.perf_counter()
    trainer.fit(verbose=True)
    fit_s = time.perf_counter() - t0
    errors, preds = trainer.evaluate("test", verbose=True)
    torch.cuda.synchronize()
    counts = {k: v for m in counted for k, v in m.LAUNCHES.items()}
    print(f"launches during the 64^3 fit + evaluate: {counts}")
    losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
    print(f"64^3 fit: 4 steps in {fit_s:.2f} s (host clock, coverage check "
          f"included); losses {losses}")
    check(len(losses) == 4 and np.isfinite(losses).all(), "non-finite 64^3 loss")
    rec = trainer.model.impl_record
    check(rec.get("impl") == "masked" and rec.get("mask_dtype") == "index"
          and rec.get("core") == [4, 8, 8], f"64^3 route is {rec}")
    check(counts["idx_dot_gather"] > 0 and counts["idx_dot_scatter"] > 0,
          "kernels D/E did not run on the 64^3 path")
    check(counts["neighbor_gather"] == 0 and counts["neighbor_scatter_add"] == 0,
          "kernels B/C ran on the 64^3 index path")
    n_test = ds.X_test.shape[0]
    check(preds.shape == (2, n_test, CELLS64 ** 3, 6) and np.isfinite(preds).all(),
          f"64^3 evaluate cube {preds.shape} not finite / wrong shape")
    check(np.array_equal(preds[0], ds.X_test[:, :, 9:]),
          "64^3 evaluate slot 0 is not the truth")
    check(np.isfinite(errors).all(), "non-finite 64^3 eval error")
    print(f"64^3 evaluate: cube {preds.shape}, errors {errors.tolist()}")

    x, y = split_batch(torch.as_tensor(ds.X_train[:1], device=dev), 9)
    step_time(trainer, x, y, 5, "64^3 b1 K14 w2 bf16 shiftinv_vel, index core "
                                "(4, 8, 8)")
    cfg = trainer.cfg
    cfg8 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, masked_core=(8, 8, 8)))
    trainer8 = Trainer(cfg8, dev, dataset=ds)
    step_time(trainer8, x, y, 5, "64^3 b1 K14 w2 bf16 shiftinv_vel, index core "
                                 "(8, 8, 8)")
    check(trainer8.model.impl_record.get("core") == [8, 8, 8],
          f"--masked_core 8 8 8 route is {trainer8.model.impl_record}")
    return counts


def run_block32(dev, C, dataset, counted):
    """Phase 8: the --impl block route at 32^3 b4 through Trainer.fit."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.train.trainer import Trainer

    cfg = C.Config(dataset.cfg, C.ModelConfig(
        family="shiftinv", channels=tuple(C.GRAPH_CHANNELS), k_neighbors=K,
        dtype="bfloat16", knn_window=WINDOW, neighbor_impl="block"),
        C.TrainConfig(num_iters=3, batch_size=BATCH, learn_rate=1e-3,
                      checkpoint_every=1))
    trainer = Trainer(cfg, dev, dataset=dataset)
    reset_counts(*counted)
    trainer.fit(verbose=True)
    torch.cuda.synchronize()
    counts = {k: v for m in counted for k, v in m.LAUNCHES.items()}
    print(f"launches during the --impl block fit: {counts}")
    losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
    check(len(losses) == 3 and np.isfinite(losses).all(), "non-finite block loss")
    check(trainer.model.impl_record.get("impl") == "block",
          f"block route is {trainer.model.impl_record}")
    check(counts["block_gather"] > 0 and counts["block_scatter"] > 0,
          "kernels F/G did not run on the --impl block path")
    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    step_time(trainer, x, y, 5, "32^3 b4 K14 w2 bf16 shiftinv, --impl block")
    return counts


def cross_route(dev, C, dataset):
    """Phase 9: one batch, one set of params, the index route (D/E) against
    the direct route (B/C), bf16 loss and gradients."""
    from nbody_tpu_torch.data.dataset import split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.physics.losses import loss_za

    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    out = {}
    params = None
    for route, mask_dtype in (("direct", "auto"), ("index", "index")):
        model = build_model(C.ModelConfig(
            family="shiftinv", channels=tuple(C.GRAPH_CHANNELS), k_neighbors=K,
            dtype="bfloat16", knn_window=WINDOW, mask_dtype=mask_dtype),
            box=4.0 * CELLS, device=dev)
        if params is None:
            params = model.params
        else:
            model.params.load_state_dict(params.state_dict())
        loss = loss_za(model(x), y)
        loss.backward()
        grads = torch.cat([p.grad.double().ravel() for p in model.parameters()])
        out[route] = (float(loss.detach()), grads, dict(model.impl_record))
    (ld, gd, rd), (li, gi, ri) = out["direct"], out["index"]
    rel = abs(li - ld) / abs(ld)
    cos = float(gd @ gi / (gd.norm() * gi.norm()))
    print(f"cross-route bf16 (32^3 b4): direct {rd['impl']} loss {ld!r}, "
          f"index {ri['impl']} {ri['core']} loss {li!r}: rel {rel:.2e}, "
          f"gradient cosine {cos:.6f}")
    check(rd["impl"] == "direct" and ri["impl"] == "masked", "routes not taken")
    check(rel <= 3e-2 and cos > 0.998, "index and direct routes disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch import config as C
    from nbody_tpu_torch.data.dataset import Dataset, split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.ops.kernels import (banded_kernels, block_kernels, build,
                                             idx_kernels, topk_kernels)
    from nbody_tpu_torch.ops.knn import lattice_sq_dist
    from nbody_tpu_torch.physics.losses import loss_za
    from nbody_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi name, power.limit: {smi}")

    # 2. build
    t0 = time.perf_counter()
    libraries = (topk_kernels.library, banded_kernels.library,
                 block_kernels.library)
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda load: load(), libraries))
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          "(one nvcc per source, in parallel)")
    for lib, info in build.BUILD_INFO.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        print(f"  {lib}: nvcc {info['seconds']:.1f} s -> {info['path']}")
        for ln in ptxas:
            print(f"    {ln}")

    # the main path's data and a first batch, for realistic kernel inputs
    cfg = C.Config(
        data=C.DataConfig(
            data_dir=os.path.join(os.path.sep, "nonexistent-force-synthetic"),
            num_test=4, num_val=2, cells_per_side=CELLS,
            synthetic_num_samples=16),
        model=C.ModelConfig(family="shiftinv", channels=tuple(C.GRAPH_CHANNELS),
                            k_neighbors=K, dtype="bfloat16", knn_window=WINDOW),
        train=C.TrainConfig(num_iters=5, batch_size=BATCH, learn_rate=1e-3,
                            checkpoint_every=1))
    t0 = time.perf_counter()
    dataset = Dataset(cfg.data)
    print(f"dataset: {dataset.X_train.shape} train, {dataset.X_test.shape} test "
          f"({time.perf_counter() - t0:.1f} s)")
    trainer = Trainer(cfg, dev, dataset=dataset)
    x0, _ = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    idx0 = trainer.model.knn_fn(x0)
    pos0 = x0[..., :3] + trainer.box / 2.0 + x0[..., 3:6]
    d2 = lattice_sq_dist(torch.remainder(pos0 / trainer.box, 1.0), CELLS,
                         window=WINDOW)
    torch.cuda.synchronize()

    # 3. kernels vs plain versions
    rec = check_kernels(dev, idx0, d2.reshape(-1, d2.shape[-1]).contiguous())

    # 4. the main path: coverage guard, fit, evaluate
    cov = trainer.check_graph_coverage(x0)
    print(f"coverage guard: {cov} violations")
    check(cov == 0, "the lattice window does not cover the data")
    counted = (topk_kernels, banded_kernels, idx_kernels, block_kernels)
    reset_counts(*counted)
    t0 = time.perf_counter()
    trainer.fit(verbose=True)
    fit_s = time.perf_counter() - t0
    errors, preds = trainer.evaluate("test", verbose=True)
    torch.cuda.synchronize()
    counters = {k: v for m in counted for k, v in m.LAUNCHES.items()}
    print(f"launches during fit + evaluate: {counters}")
    losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
    print(f"fit: 5 steps in {fit_s:.2f} s (host clock, coverage check "
          f"included); losses {losses}")
    check(len(losses) == 5 and np.isfinite(losses).all(), "non-finite loss")
    check(all(counters[n] > 0 for n in
              ("topk_min", "neighbor_gather", "neighbor_scatter_add")),
          "a kernel was not launched")
    check(preds.shape == (2, 4, CELLS ** 3, 3) and np.isfinite(preds).all(),
          f"evaluate cube {preds.shape} not finite / wrong shape")
    check(np.array_equal(preds[0], dataset.X_test[:4, :, 6:]),
          "evaluate slot 0 is not the truth")
    check(np.isfinite(errors).all(), "non-finite eval error")
    print(f"evaluate: cube {preds.shape}, errors {errors.tolist()}")

    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    step_time(trainer, x, y, 10, "32^3 b4 K14 w2 bf16")
    del trainer

    # 5. card vs CPU, f32, one cube
    mcfg = C.ModelConfig(family="shiftinv", channels=tuple(C.GRAPH_CHANNELS),
                         k_neighbors=K, dtype="float32", knn_window=WINDOW)
    xb, yb = split_batch(torch.as_tensor(dataset.X_test[:1]))
    losses_dev = {}
    idx_dev = {}
    for d in (dev, torch.device("cpu")):
        model = build_model(mcfg, box=4.0 * CELLS, device=d)
        with torch.no_grad():
            idx_dev[d.type] = model.knn_fn(xb.to(d)).cpu()
            losses_dev[d.type] = float(loss_za(model(xb.to(d)), yb.to(d)))
    rel = abs(losses_dev["cuda"] - losses_dev["cpu"]) / abs(losses_dev["cpu"])
    idx_rows = int((idx_dev["cuda"] != idx_dev["cpu"]).any(-1).sum())
    print(f"card vs CPU f32 loss: {losses_dev['cuda']!r} vs {losses_dev['cpu']!r} "
          f"(rel {rel:.2e}); kNN rows differing: {idx_rows}")
    check(rel <= 1e-4, "card and CPU f32 losses disagree")

    # 6. kernels D-G vs plain versions, at the shapes of the 64^3 graph
    ds64, trainer64 = make_vel64(dev, C)
    x64, _ = split_batch(torch.as_tensor(ds64.X_train[:1], device=dev), 9)
    idx64 = trainer64.model.knn_fn(x64)
    rec.update(check_select_kernels(dev, idx64, idx0))
    del x64, idx64
    # 7. the 64^3 shiftinv_vel index path
    counts64 = run_vel64(dev, ds64, trainer64, counted)
    del trainer64, ds64
    for n in ("idx_dot_gather", "idx_dot_scatter"):
        counters[n] = counts64[n]
    # 8. the --impl block route
    counts_block = run_block32(dev, C, dataset, counted)
    for n in ("block_gather", "block_scatter"):
        counters[n] = counts_block[n]
    # 9. index route against the direct route
    cross_route(dev, C, dataset)

    kernels = [{"name": n, "route": "cuda", "source": REPO_KERNELS[n][0],
                "replaces": REPO_KERNELS[n][1], "launches": counters[n],
                "max_abs_err": rec[n]["max_abs_err"], "ms": rec[n]["ms"],
                "plain_ms": rec[n]["plain_ms"]} for n in REPO_KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
