#!/usr/bin/env python3
"""Drive the PyTorch port (nbody_tpu_torch) once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. find the card; print its name and nvidia-smi's name and power limit;
  2. build the CUDA kernels from nbody_tpu_torch/csrc with nvcc;
  3. hold every kernel against its plain PyTorch version on the card, at
     the main path's shapes (32^3 particles, batch 4, K 14, window 2),
     check the two autograd Functions' gradients, and time kernel and
     plain version with CUDA events;
  4. drive the main path through its entry points: Dataset (16 synthetic
     32^3 cubes), Trainer with the coverage guard, 5 bf16 fit steps and
     evaluate on the test split, counting kernel launches; then time the
     train step and read the peak device memory;
  5. one f32 forward + loss of the same params and cube on the card and on
     the CPU (plain versions) must agree to rtol 1e-4.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CELLS, BATCH, K, WINDOW = 32, 4, 14, 2
WIDTHS = (3, 16, 32, 64)          # the layer widths the gather/scatter see
REPO_KERNELS = {
    "topk_min": ("nbody_tpu_torch/csrc/topk_kernels.cu",
                 "nbody_tpu/ops/pallas/topk_kernels.py:46"),
    "neighbor_gather": ("nbody_tpu_torch/csrc/banded_kernels.cu",
                        "nbody_tpu/ops/pallas/banded_kernels.py:113"),
    "neighbor_scatter_add": ("nbody_tpu_torch/csrc/banded_kernels.cu",
                             "nbody_tpu/ops/pallas/banded_kernels.py:170"),
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
    rec = {name: {"max_abs_err": 0.0} for name in REPO_KERNELS}

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch import config as C
    from nbody_tpu_torch.data.dataset import Dataset, split_batch
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.ops.kernels import banded_kernels, build, topk_kernels
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
    topk_kernels.library()
    banded_kernels.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
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
    for d in (topk_kernels.LAUNCHES, banded_kernels.LAUNCHES):
        d.update(dict.fromkeys(d, 0))
    t0 = time.perf_counter()
    trainer.fit(verbose=True)
    fit_s = time.perf_counter() - t0
    errors, preds = trainer.evaluate("test", verbose=True)
    torch.cuda.synchronize()
    counters = {**topk_kernels.LAUNCHES, **banded_kernels.LAUNCHES}
    print(f"launches during fit + evaluate: {counters}")
    losses = [r["loss"] for r in trainer.metrics_log if "step" in r]
    print(f"fit: 5 steps in {fit_s:.2f} s (host clock, coverage check "
          f"included); losses {losses}")
    check(len(losses) == 5 and np.isfinite(losses).all(), "non-finite loss")
    check(all(v > 0 for v in counters.values()), "a kernel was not launched")
    check(preds.shape == (2, 4, CELLS ** 3, 3) and np.isfinite(preds).all(),
          f"evaluate cube {preds.shape} not finite / wrong shape")
    check(np.array_equal(preds[0], dataset.X_test[:4, :, 6:]),
          "evaluate slot 0 is not the truth")
    check(np.isfinite(errors).all(), "non-finite eval error")
    print(f"evaluate: cube {preds.shape}, errors {errors.tolist()}")

    x, y = split_batch(torch.as_tensor(dataset.X_train[:BATCH], device=dev))
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: trainer.train_step(x, y), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"train step (32^3 b4 K14 w2 bf16, CUDA events, mean of 10 after "
          f"warm-up): {step_ms:.3f} ms; peak device memory {peak / 2**20:.1f} MiB")

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
