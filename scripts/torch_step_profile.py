#!/usr/bin/env python3
"""Time the PyTorch port's train steps on each neighbor route, its graph
build and its scatters on one CUDA card.

    python3 scripts/torch_step_profile.py [--root DIR] [--label NAME] [--profile]
                                          [--out_dir DIR]

Imports nbody_tpu_torch from DIR (default: the checkout holding this
script), so that one command can measure two trees in turns, e.g. a parent
commit unpacked with ``git archive`` and the working tree: parent, change,
change, parent.  On synthetic cubes made from a fixed seed it measures:
  * the train step of each route of ROUTES (K 14, lattice window 2, bf16
    compute): shiftinv at 32^3 batch 4 on the direct, --impl block, int8
    and int4 routes, shiftinv_vel at 64^3 batch 1 on the direct and
    --mask_dtype index routes: CUDA events, mean of 10 steps after 2
    warm-up, the peak device memory of those steps, and every kernel
    launch of one step (the program's launch.<wrapper> counters, or an
    older tree's LAUNCHES dicts);
  * on the index and block routes, the block plan's build where the tree
    has one (blocked.block_index_plan);
  * the graph build (the model's knn_fn) and kernel A's own launch at 32^3
    b4: the fused lattice_knn where the tree has it, else topk_min on the
    precomputed distances;
  * kernel C at 32^3 b4 K14, C 64 bf16 through the tree's wrapper:
    neighbor_segment_sum over a prebuilt plan (and the plan's own build)
    where the tree has it, else the atomic neighbor_scatter_add (its memset
    and cast included);
  * the bytes kernels B and C move in one 32^3 train step (each input read
    once, each output written once, summed over their launches) and the
    bound they give at 3.35 TB/s (H100 SXM);
  * with --profile, torch.profiler over 3 steps of each route: device
    time per step by bucket of kernel names (kernels D-G, H and I apart),
    kernels per step, busy time and idle share.
Prints one JSON line, with the card's name and power limit, and writes it
to <out_dir>/step_profile_<label>.json (default build/, which git
ignores).  Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, WINDOW = 14, 2
# route -> (family, cells, batch, ModelConfig overrides, impl_record subset)
ROUTES = {
    "direct32": ("shiftinv", 32, 4, {}, {"impl": "direct"}),
    "direct64": ("shiftinv_vel", 64, 1, {}, {"impl": "direct"}),
    "index64": ("shiftinv_vel", 64, 1, {"mask_dtype": "index"},
                {"impl": "masked", "mask_dtype": "index"}),
    "block32": ("shiftinv", 32, 4, {"neighbor_impl": "block"}, {"impl": "block"}),
    "int8_32": ("shiftinv", 32, 4, {"mask_dtype": "int8"},
                {"impl": "masked", "mask_dtype": "int8"}),
    "int4_32": ("shiftinv", 32, 4, {"mask_dtype": "int4"},
                {"impl": "masked", "mask_dtype": "int4"}),
}
H100_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA's data sheet
BUCKETS = (
    ("A lattice_knn", ("lattice_knn_kernel",)),
    ("A topk_min", ("topk_min_kernel",)),
    ("B gather", ("gather_rows_kernel",)),
    # E/G: the shared-memory atomic form, or the segment sum's instance
    # tagged block_sites (C's is tagged graph_targets)
    ("E/G scatter", ("select_scatter_kernel", "segment_sum_kernel<block_sites")),
    ("C segment sum", ("segment_sum_kernel",)),
    # D/F: patch_gather_kernel, or in a tree before it select_gather_kernel
    ("D/F gather", ("patch_gather_kernel", "select_gather_kernel")),
    # I: mask_scatter_kernel, or in a tree before it the transposed
    # instances mask_dot_kernel<true, kInt4, NF>; H: mask_gather_kernel, or
    # in a tree before it the other mask_dot_kernel instances
    ("I mask scatter", ("mask_scatter_kernel", "mask_dot_kernel<true, true,",
                        "mask_dot_kernel<true, false,")),
    ("H mask gather", ("mask_gather_kernel", "mask_dot_kernel")),
    ("C atomic scatter", ("scatter_add_kernel",)),
    ("sort + search", ("adix", "sort", "Sort", "searchsorted")),
    ("matmul", ("gemm", "Gemm", "cutlass", "xmma", "sm90", "cublas", "ampere")),
    ("reduction", ("reduce_kernel",)),
    ("torch index / scatter", ("index", "Index", "scatter_gather")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Elementwise")),
    ("copy / fill / cat", ("Memcpy", "Memset", "copy", "fill", "Cat")),
)


def cuda_ms(fn, iters=10, warmup=2):
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


def step_bytes(step, module, names):
    """Launches and bytes (tensor arguments, plans included, and the
    output) of the wrappers `names` of `module` over one call of step."""
    counts = {n: [0, 0] for n in names if hasattr(module, n)}
    originals = {n: getattr(module, n) for n in counts}

    def counted(name, fn):
        def call(*args):
            out = fn(*args)
            ts = [out] + [t for a in args
                          for t in (a if isinstance(a, tuple) else (a,))
                          if torch.is_tensor(t)]
            counts[name][0] += 1
            counts[name][1] += sum(t.numel() * t.element_size() for t in ts)
            return out
        return call

    for n, fn in originals.items():
        setattr(module, n, counted(n, fn))
    try:
        step()
        torch.cuda.synchronize()
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)
    return {n: {"launches": c, "bytes": b, "bound_ms": b / H100_BYTES_PER_S * 1e3}
            for n, (c, b) in counts.items()}


def bucket_of(name: str) -> str:
    for label, pats in BUCKETS:
        if any(p in name for p in pats):
            return label
    return "other"


def profile_steps(step, steps=3):
    """Device time per step by bucket, kernels per step, busy and idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            step()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    buckets, launches, top = {}, 0, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        b = buckets.setdefault(bucket_of(evt.key), {"ms": 0.0, "launches": 0})
        b["ms"] += us / 1e3 / steps
        b["launches"] += evt.count / steps
        launches += evt.count
        top.append((us / 1e3 / steps, evt.count / steps, evt.key[:90]))
    busy = sum(b["ms"] for b in buckets.values())
    top.sort(reverse=True)
    return {"wall_ms_per_step": wall / steps, "busy_ms_per_step": busy,
            "idle_share": 1.0 - busy * steps / wall,
            "kernels_per_step": launches / steps,
            "buckets": dict(sorted(buckets.items(), key=lambda kv: -kv[1]["ms"])),
            "top_kernels": top[:15]}


def launch_counter(kernel_modules):
    """(reset, read) of the tree's kernel launches a wrapper: the program's
    launch.<wrapper> counters (nbody_tpu_torch/tracing.py) where the tree
    has them, else the wrapper modules' LAUNCHES dicts."""
    try:
        from nbody_tpu_torch import tracing
    except ImportError:
        def reset():
            for m in kernel_modules:
                m.LAUNCHES.update(dict.fromkeys(m.LAUNCHES, 0))

        return reset, lambda: {k: v for m in kernel_modules
                               for k, v in m.LAUNCHES.items() if v}
    return tracing.reset, lambda: {k[len("launch."):]: v for k, v in
                                   tracing.counters().items()
                                   if k.startswith("launch.") and v}

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out_dir", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import nbody_tpu_torch
    if not os.path.abspath(nbody_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"nbody_tpu_torch came from {nbody_tpu_torch.__file__}")
    from nbody_tpu_torch import config as C
    from nbody_tpu_torch.data.dataset import features_from_raw, split_batch
    from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
    from nbody_tpu_torch.models.registry import build_model
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import banded_kernels as B
    from nbody_tpu_torch.ops.kernels import (block_kernels, idx_kernels,
                                             mask_kernels)
    from nbody_tpu_torch.ops.kernels import topk_kernels as T
    from nbody_tpu_torch.train.trainer import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result = {"label": args.label, "root": root, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "torch": torch.__version__, "steps": {}}

    reset_launches, read_launches = launch_counter(
        (T, B, idx_kernels, block_kernels, mask_kernels))
    for route in ROUTES:
        family, cells, batch, overrides, want = ROUTES[route]
        vel = family == "shiftinv_vel"
        x = torch.from_numpy(features_from_raw(
            synthetic_raw_cubes(batch, cells, seed=0), include_velocity=vel)).to(dev)
        x_in, y = split_batch(x, 9 if vel else 6)
        channels = C.GRAPH_VEL_CHANNELS if vel else C.GRAPH_CHANNELS
        model = build_model(C.ModelConfig(
            family=family, channels=tuple(channels), k_neighbors=K,
            dtype="bfloat16", knn_window=WINDOW, **overrides),
            box=4.0 * cells, device=dev)
        step = make_train_step(model, make_optimizer(model, 1e-3))
        step(x_in, y)
        if any(model.impl_record.get(k) != v for k, v in want.items()):
            raise RuntimeError(f"route {route}: {model.impl_record}, not {want}")
        reset_launches()
        step(x_in, y)
        torch.cuda.synchronize()
        launches = read_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: step(x_in, y))
        peak = torch.cuda.max_memory_allocated(dev)
        rec = {"ms": ms, "peak_mib": peak / 2 ** 20, "launches": launches,
               "knn_ms": cuda_ms(lambda: model.knn_fn(x_in)),
               "impl_record": dict(model.impl_record)}
        core = model.impl_record.get("core")
        if core and route in ("index64", "block32") and hasattr(
                blocked, "block_index_plan"):
            idx = model.knn_fn(x_in)
            rec["plan_ms"] = cuda_ms(lambda: blocked.block_index_plan(
                idx, cells, WINDOW, tuple(core), drop_self_slot0=route == "index64"))
        key = f"{cells}^3 b{batch} {family} {route}"
        result["steps"][key] = rec
        print(f"{key}: step {ms:.3f} ms, peak {peak / 2 ** 20:.1f} MiB, graph "
              f"build {rec['knn_ms']:.4f} ms, plan {rec.get('plan_ms')} ms, "
              f"launches/step {launches} ({smi})", flush=True)
        if args.profile:
            prof = profile_steps(lambda: step(x_in, y))
            rec["profile"] = prof
            print(f"profile {key}: {prof['kernels_per_step']:.0f} kernels/step, "
                  f"busy {prof['busy_ms_per_step']:.3f} ms, wall "
                  f"{prof['wall_ms_per_step']:.3f} ms, idle {prof['idle_share']:.3f}")
            for name, b in prof["buckets"].items():
                print(f"  {name:<24} {b['ms']:8.3f} ms  {b['launches']:6.0f} launches")
        if route != "direct32":
            del model, step, x, x_in, y
            torch.cuda.empty_cache()
            continue
        idx = model.knn_fn(x_in)
        pn = torch.remainder((x_in[..., :3] + 2.0 * cells + x_in[..., 3:6])
                             / (4.0 * cells), 1.0)
        if hasattr(T, "lattice_knn"):
            result["kernel_a"] = ("lattice_knn", cuda_ms(
                lambda: T.lattice_knn(pn, K, cells, WINDOW)))
        else:
            from nbody_tpu_torch.ops.knn import lattice_sq_dist
            d2 = lattice_sq_dist(pn, cells, window=WINDOW)
            d2 = d2.reshape(-1, d2.shape[-1]).contiguous()
            result["kernel_a"] = ("topk_min", cuda_ms(lambda: T.topk_min(d2, K)))
        e = torch.randn((batch, cells ** 3, K, 64), device=dev).to(torch.bfloat16)
        if hasattr(B, "neighbor_segment_sum"):
            plan = B.graph_plan(idx)
            result["kernel_c"] = ("neighbor_segment_sum", cuda_ms(
                lambda: B.neighbor_segment_sum(e, plan)))
            result["plan_ms"] = cuda_ms(lambda: B.graph_plan(idx))
        else:
            result["kernel_c"] = ("neighbor_scatter_add", cuda_ms(
                lambda: B.neighbor_scatter_add(e, idx)))
        print(f"kernel A {result['kernel_a']}, kernel C {result['kernel_c']} ms, "
              f"plan {result.get('plan_ms')} ms", flush=True)
        # the wrappers kernel B / C launch through, in either tree
        moved = step_bytes(lambda: step(x_in, y), B, (
            "neighbor_gather", "neighbor_segment_sum", "neighbor_scatter_add"))
        if "neighbor_segment_sum" in moved:
            moved.pop("neighbor_scatter_add", None)   # it runs the segment sum
        result["step_bytes_32"] = moved
        print(f"kernels B/C in one step: {moved}", flush=True)
        del model, step, x, x_in, y, e, idx
        torch.cuda.empty_cache()

    line = json.dumps(result)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"step_profile_{args.label}.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
