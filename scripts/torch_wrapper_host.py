#!/usr/bin/env python3
"""Host time per call of the block-selection wrappers (kernels D-G) on one
CUDA card, and where it goes.

    python3 scripts/torch_wrapper_host.py [--root DIR] [--label NAME] [--out_dir DIR]

Imports nbody_tpu_torch from DIR (default: the checkout holding this
script), so that one command can measure two trees in turns.  On the
shapes the main paths give the wrappers -- the 64^3 b1 index route's core
(4, 8, 8) (kernels D and E) and the 32^3 b4 block route's core (4, 4, 8)
(F and G), over the lattice kNN graph (K 14, window 2) of a synthetic cube
made from a fixed seed -- at C 1 and C 64 in bf16, it measures per call:
  * host_us: the host's time, perf_counter around 200 calls whose kernels
    are queued and not waited for (median of 5 such runs);
  * event_ms: CUDA events around 20 calls, what chip_smoke.py reports (at
    C 1 the host's time, since the device waits for it);
  * device_ms: the kernels' own time (torch.profiler);
and, for the scatter E and the gather D, host_us of each piece of the
wrapper run alone: the checks, the bf16 cast, the output's allocation,
the vector width, the library lookup, the stream lookup (PyTorch's Stream
object and the raw handle), the shared-memory query of the gathers, and
the C entry with its launch.
Prints one JSON line, with the card's name and power limit, and writes it
to <out_dir>/wrapper_host_<label>.json (default build/, which git
ignores).  Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, WINDOW = 14, 2
WIDTHS = (1, 64)


def host_us(fn, n=200, runs=5):
    """Median over `runs` of the host's microseconds per call of fn."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per_call.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def event_ms(fn, iters=20, warmup=3):
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


def device_ms(fn, iters=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out_dir", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wrapper_host: no CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import nbody_tpu_torch
    if not os.path.abspath(nbody_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"nbody_tpu_torch came from {nbody_tpu_torch.__file__}")
    from nbody_tpu_torch.data.dataset import features_from_raw
    from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import block_kernels as BK
    from nbody_tpu_torch.ops.kernels import idx_kernels as IK
    from nbody_tpu_torch.ops.kernels import topk_kernels as T

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result = {"label": args.label, "root": root, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "torch": torch.__version__, "calls": {},
              "pieces": {}}
    g = torch.Generator(device=dev).manual_seed(0)

    def graph(batch, cells):
        x = torch.from_numpy(features_from_raw(synthetic_raw_cubes(batch, cells, seed=0),
                                               include_velocity=False)).to(dev)
        pn = torch.remainder((x[..., :3] + 2.0 * cells + x[..., 3:6]) / (4.0 * cells), 1.0)
        return T.lattice_knn(pn.contiguous(), K, cells, WINDOW)

    index = blocked.block_index_plan(graph(1, 64), 64, WINDOW, (4, 8, 8),
                                     drop_self_slot0=True)
    p_index = blocked.patch_size(64, WINDOW, (4, 8, 8))
    block = blocked.block_index_plan(graph(4, 32), 32, WINDOW, blocked.CORE)
    p_block = blocked.patch_size(32, WINDOW, blocked.CORE)
    cases = {
        "idx_dot_gather": (index, p_index, False,
                           lambda pl, x, p: IK.dot_gather(pl.pos, x)),
        "idx_dot_scatter": (index, p_index, True,
                            lambda pl, x, p: IK.dot_scatter(pl, x, p)),
        "block_gather": (block, p_block, False,
                         lambda pl, x, p: BK.block_gather(pl.pos, x, True)),
        "block_scatter": (block, p_block, True,
                          lambda pl, x, p: BK.block_scatter(pl, x, p, True)),
    }
    for name, (plan, p, scatter, call) in cases.items():
        b, nb, et = plan.pos.shape
        for c in WIDTHS:
            x = torch.randn((b, nb, et if scatter else p, c), generator=g,
                            device=dev).to(torch.bfloat16)
            fn = lambda: call(plan, x, p)   # noqa: E731
            rec = {"host_us": host_us(fn), "event_ms": event_ms(fn),
                   "device_ms": device_ms(fn)}
            result["calls"][f"{name} C={c}"] = rec
            print(f"{name} {tuple(plan.pos.shape)} P={p} C={c:>2}: host "
                  f"{rec['host_us']:.2f} us/call, event {rec['event_ms']:.4f} ms, "
                  f"device {rec['device_ms']:.4f} ms ({smi})", flush=True)

    # the pieces of the index route's E and D calls at C 1, each alone
    lib = BK.library()
    b, nb, et = index.pos.shape
    x = torch.randn((b, nb, et, 1), generator=g, device=dev).to(torch.bfloat16)
    pat = torch.randn((b, nb, p_index, 1), generator=g, device=dev).to(torch.bfloat16)
    out_s = torch.empty((b, nb, p_index, 1), dtype=torch.float32, device=dev)
    out_g = torch.empty((b, nb, et, 1), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the gather's tiling arguments at C 1: (path, CTAs per block), or in a
    # tree before gather_tiling (channels per CTA, vector width)
    gather_args = (BK.gather_tiling(et, 1, 2, True, True)
                   if hasattr(BK, "gather_tiling") else (1, 1))
    pieces = {
        "check_plan": lambda: BK.check_plan(index, x, p_index, "idx_dot_scatter"),
        "check_select": lambda: BK.check_select(index.pos, pat, "idx_dot_gather"),
        "cast to bf16 (no-op)": lambda: x.to(torch.bfloat16),
        "torch.empty": lambda: torch.empty((b, nb, p_index, 1), dtype=torch.float32,
                                           device=x.device),
        "new_empty": lambda: x.new_empty((b, nb, p_index, 1), dtype=torch.float32),
        "vector_width": lambda: BK.vector_width(1, 2, x.data_ptr()),
        "library()": BK.library,
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "C entry, scatter": lambda: lib.block_select_scatter(
            x.data_ptr(), index.order.data_ptr(), index.offsets.data_ptr(),
            out_s.data_ptr(), b * nb * p_index, b * nb * et, 1, 1, 1, 0, 0, stream),
        "C entry, gather": lambda: lib.block_select_gather(
            pat.data_ptr(), index.pos.data_ptr(), out_g.data_ptr(), b * nb,
            p_index, et, 1, *gather_args, 1, 0, 0, stream),
    }
    for piece, fn in pieces.items():
        result["pieces"][piece] = host_us(fn)
        print(f"piece {piece:<30} {result['pieces'][piece]:7.2f} us/call", flush=True)

    line = json.dumps(result)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"wrapper_host_{args.label}.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
