#!/usr/bin/env python3
"""Variant timings of kernel J (csrc/fused_kernels.cu, the fused layer
boundary) on one CUDA card, beside the yardsticks it is measured against.

    python3 scripts/torch_fused_variants.py [--parent DIR] [--only BUILDS]
        [--shapes LABELS] [--rounds 2] [--out_dir DIR]

Shapes: the scripts/bench_fused.py workload at full size -- one-hot bf16
masks from ops/blocked.block_masks of a lattice kNN graph (K 14, window 2,
self slot dropped) of four synthetic 32^3 cubes -- at core (4,8,8) (masks
(4, 128, 3328, 1152), 3.93 GB) with C = q = 32 and every interior layer
boundary of shiftinv (C, q) = (32, 64), (64, 64), (64, 32), (32, 16),
(16, 3), and at core (8,8,8) (P 1,728) with C = q = 32.  Patches, a_edge
and the weights are bf16 from a fixed seed at bench_fused's scales (1,
0.01, 0.1).  Builds (--only takes a comma-separated subset; all by
default):
  - kernel: the committed kernel with the tiling fused_tiling chooses, with
    each other cluster size that fits (k 1, 2, 4), and with 16-row stages
    where it chose 32;
  - patches-l2: the committed source with the patch B fragments read from
    global memory (L2) at every tile instead of held in registers;
  - ring-alone: the committed source without its two mask products and
    the stores of s (the TMA ring, the cluster exchange and the per-edge
    chain alone; timing only: its output is wrong);
  - parent: DIR/nbody_tpu_torch/csrc/mask_kernels.cu of a tree from before
    this design (fused_boundary: s in shared memory, wmma, one CTA a
    block); shapes it refuses are reported as refused;
  - chain: the unfused chain of bf16 torch.matmul calls (M . patches, + a
    and relu, the two weight products, M^T . hw), which reads the mask
    twice: the yardstick a fused kernel must beat (not one library call);
  - ring: kernel H's TMA mask ring alone (scripts/mask_ring.cu, as
    scripts/torch_mask_ring.py runs it) over the same bf16 masks as bytes:
    the stream rate this card's TMA gives here.
Every source is built with nvcc into build/fused_variants, all at once.
Each output of the kernels is held against boundary_reference at
chip_smoke.py's tolerances; times per call with CUDA events (`rounds`
rounds, in turns over the variants, 5 calls after 1 warm-up) and on the
device alone (torch.profiler).  The bound is max(bytes / 3.35 TB/s,
flops / 989 TFLOP/s) of the call (masks, patches, a_edge, W1, W2 in; act,
h1, s out).  Prints one line per variant and shape with the card's name
and power limit, and writes everything as JSON to
<out_dir>/fused_variants.json.  Fails without a card, or where a kernel
variant is out of tolerance.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from nbody_tpu_torch.ops.kernels import build  # noqa: E402
from nbody_tpu_torch.ops.kernels import fused_kernels as FK  # noqa: E402

CELLS, BATCH, K, WINDOW = 32, 4, 14, 2
H100_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet
H100_BF16_TC_OPS = 989e12        # dense bf16 tensor cores, the same sheet
SCALES = (1.0, 0.01, 0.1)        # patches, a_edge, weights (bench_fused)
# label: (core, C, q)
SHAPES = {
    "(4,8,8) C32 q32": ((4, 8, 8), 32, 32),
    "(4,8,8) C32 q64": ((4, 8, 8), 32, 64),
    "(4,8,8) C64 q64": ((4, 8, 8), 64, 64),
    "(4,8,8) C64 q32": ((4, 8, 8), 64, 32),
    "(4,8,8) C32 q16": ((4, 8, 8), 32, 16),
    "(4,8,8) C16 q3": ((4, 8, 8), 16, 3),
    "(8,8,8) C32 q32": ((8, 8, 8), 32, 32),
}
# chip_smoke.py's tolerances (rtol, atol) of act, h1 and s in bf16
TOL = ((2e-2, 2e-2), (2e-2, 2e-1), (2e-2, 2e-1))
KERNEL_SRC = "nbody_tpu_torch/csrc/fused_kernels.cu"
# build: (label, [(text, replacement), ...]) of the committed source
TEXT_VARIANTS = {
    "patches-l2": ("patches through L2", [
        ("#define FUSED_PATCH_FRAGS_IN_REGISTERS 1",
         "#define FUSED_PATCH_FRAGS_IN_REGISTERS 0")]),
    "ring-alone": ("ring, exchange and chain alone (timing only)", [
        ("#define FUSED_PRODUCTS 1", "#define FUSED_PRODUCTS 0")]),
}
# kernel H's ring over the bf16 mask bytes: (label, rows per warp, consumer
# warps, stage bytes, stages), TMA, one CTA per SM, L2 promotion 128 B,
# evict-normal (PR 8's best)
RINGS = (("64x8 64B x4", 64, 8, 64, 4), ("64x8 128B x3", 64, 8, 128, 3))
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
PARENT_TYPES = {"fused_boundary": (_P,) * 8 + (_L,) + (_I,) * 9 + (_P,),
                "fused_boundary_smem_bytes": (_I,) * 5 + (ctypes.POINTER(_I),),
                "mask_max_smem": (_I,)}


def _nvcc(src_path: str, out_dir: str, label: str, include: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "lib.so")
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", include,
                           "-o", lib_path, src_path], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise build.KernelBuildError(f"{label}:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"built {label}: " + "; ".join(regs[:4]), flush=True)
    return lib_path


def build_variant(key: str, out_dir: str) -> ctypes.CDLL:
    """The committed kernel source with TEXT_VARIANTS[key]'s replacements."""
    label, replace = TEXT_VARIANTS[key]
    path = os.path.join(HERE, KERNEL_SRC)
    src = open(path).read()
    for old, new in replace:
        if old not in src:
            raise RuntimeError(f"{label}: text not in {KERNEL_SRC}: {old!r}")
        src = src.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    copy = os.path.join(out_dir, os.path.basename(path))
    with open(copy, "w") as f:
        f.write(src)
    lib = ctypes.CDLL(_nvcc(copy, out_dir, label, os.path.dirname(path)))
    for entry, types in FK._SIGNATURES.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = list(types), ctypes.c_int
    return lib


def build_parent(parent: str, out_dir: str) -> ctypes.CDLL:
    src = os.path.join(os.path.abspath(parent), "nbody_tpu_torch", "csrc",
                       "mask_kernels.cu")
    lib = ctypes.CDLL(_nvcc(src, out_dir, "parent", os.path.dirname(src)))
    for entry, types in PARENT_TYPES.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = list(types), ctypes.c_int
    return lib


def build_ring(out_dir: str) -> ctypes.CDLL:
    src = os.path.join(HERE, "scripts", "mask_ring.cu")
    lib = ctypes.CDLL(_nvcc(src, out_dir, "ring", os.path.dirname(src)))
    lib.mask_ring.argtypes = [_P, _P, _L] + [_I] * 10 + [_P]
    lib.mask_ring.restype = ctypes.c_int
    lib.sm_count.argtypes = [_I]
    return lib


def cuda_ms(fn, iters=5, warmup=1):
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


def device_ms(fn, iters=5):
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


def xor_all(words: torch.Tensor) -> int:
    w = words.flatten()
    while w.numel() > 1:
        if w.numel() % 2:
            w = torch.cat([w, w.new_zeros(1)])
        h = w.numel() // 2
        w = w[:h] ^ w[h:]
    return int(w.item()) & 0xFFFFFFFF


def outputs(masks, pat, q):
    """Empty (act, h1, s) for one call: act in the patches' dtype, h1 and s
    f32."""
    b, nb, et, p = masks.shape
    kw = {"device": masks.device}
    return (torch.empty((b, nb, et, pat.shape[-1]), dtype=pat.dtype, **kw),
            torch.empty((b, nb, et, q), dtype=torch.float32, **kw),
            torch.empty((b, nb, p, q), dtype=torch.float32, **kw))


def within(got, want):
    """(max |err| over the three outputs, worst err - tolerance)."""
    err_max, worst = 0.0, -float("inf")
    for (rtol, atol), g, w in zip(TOL, got, want):
        err = (g.float() - w.float()).abs()
        err_max = max(err_max, float(err.max()))
        worst = max(worst, float((err - (atol + rtol * w.float().abs())).max()))
    return err_max, worst


def calls_at(libs, masks, args, tilings, smem_limit):
    """{label: (call, outputs or None)} at one shape."""
    b, nb, et, p = masks.shape
    pat, a, w1, w2 = args
    c, q = pat.shape[-1], w1.shape[-1]
    dev = masks.device.index
    stream = build.stream(dev)
    calls = {}
    for key, lib in libs.items():
        if key == "parent":
            tc = ctypes.c_int(0)
            need = lib.fused_boundary_smem_bytes(p, c, q, 2, dev, ctypes.byref(tc))
            if need > lib.mask_max_smem(dev):
                calls["parent"] = None           # the parent refuses the shape
                continue
            outs = outputs(masks, pat, q)
            f1, f2 = w1.float().contiguous(), w2.float().contiguous()

            def run(lib=lib, outs=outs, f1=f1, f2=f2):
                build.check_launch(lib.fused_boundary(
                    masks.data_ptr(), pat.data_ptr(), a.data_ptr(), f1.data_ptr(),
                    f2.data_ptr(), *(o.data_ptr() for o in outs), b * nb, et, p, c,
                    q, 1, 1, 1, 1, dev, stream), "parent fused_boundary")
            calls["parent"] = (run, outs)
        elif key == "chain":
            m2 = masks.reshape(b * nb, et, p)
            mt = m2.transpose(1, 2)
            p2, a2 = pat.reshape(b * nb, p, c), a.reshape(b * nb, et, c)

            def run(m2=m2, mt=mt, p2=p2, a2=a2):
                act = torch.relu(torch.matmul(m2, p2) + a2)
                torch.matmul(act, w1)
                torch.matmul(mt, torch.matmul(act, w2))
            calls["chain (bf16 torch.matmul, unfused)"] = (run, None)
        elif key in ("kernel",) + tuple(TEXT_VARIANTS):
            name = "kernel" if key == "kernel" else TEXT_VARIANTS[key][0]
            for k, tl in tilings.items():
                if key != "kernel" and k != "chosen":
                    continue
                outs = outputs(masks, pat, q)
                label = (f"{name} {k} (k={tl.cluster}, {tl.warps}+{tl.chains}+1 warps, "
                         f"R {tl.rows}, {tl.stages} stages)")

                def run(lib=lib, tl=tl, outs=outs):
                    FK.launch(lib, tl, masks, pat, a, w1, w2, outs)
                calls[label] = (run, None if key == "ring-alone" else outs)
        elif key == "ring":
            raw = masks.view(torch.uint8)
            rb = 2 * p
            sms = lib.sm_count(dev)
            for ring, rpw, warps, kw, stages in RINGS:
                out = torch.zeros(sms * (warps + 1) * 32, dtype=torch.int32,
                                  device=masks.device)

                def run(lib=lib, rpw=rpw, warps=warps, kw=kw, stages=stages, out=out):
                    err = lib.mask_ring(raw.data_ptr(), out.data_ptr(), b * nb, et, rb,
                                        rpw, warps, kw, stages, 1, sms, 128, 0, stream)
                    build.check_launch(err, "mask_ring")
                calls[f"H's TMA ring alone {ring}"] = (run, ("ring", out, raw))
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--only", default=None)
    ap.add_argument("--shapes", default=None,
                    help="comma-separated labels of SHAPES (all by default)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out_dir", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_variants: no CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.data.dataset import features_from_raw
    from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import topk_kernels as T

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}", flush=True)

    vdir = os.path.join(os.path.dirname(build.BUILD_DIR), "fused_variants")
    jobs = {"kernel": lambda: FK.library(), "chain": lambda: None,
            "ring": lambda: build_ring(os.path.join(vdir, "ring"))}
    for key in TEXT_VARIANTS:
        jobs[key] = lambda key=key: build_variant(key, os.path.join(vdir, key))
    if args.parent:
        jobs["parent"] = lambda: build_parent(args.parent, os.path.join(vdir, "parent"))
    if args.only:
        jobs = {k: fn for k, fn in jobs.items() if k in args.only.split(",")}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        libs = {k: f.result() for k, f in futures.items()}
    print(f"built: {sorted(libs)}", flush=True)
    for ln in build.BUILD_INFO.get("fused_kernels", {}).get("log", "").splitlines():
        if "registers" in ln or "spill" in ln or "entry function" in ln:
            print(f"  ptxas: {ln.strip()}")

    x = torch.from_numpy(features_from_raw(synthetic_raw_cubes(BATCH, CELLS, seed=0),
                                           include_velocity=False)).to(dev)
    pn = torch.remainder((x[..., :3] + 2.0 * CELLS + x[..., 3:6]) / (4.0 * CELLS), 1.0)
    idx = T.lattice_knn(pn.contiguous(), K, CELLS, WINDOW)
    smem_limit = FK.max_smem(dev) if "kernel" in libs else 0
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "shapes": {}}
    labels = args.shapes.split(",") if args.shapes else list(SHAPES)
    masks, mcore = None, None
    failed = []
    for label in labels:
        core, c, q = SHAPES[label]
        if core != mcore:
            masks = None
            torch.cuda.empty_cache()
            masks = blocked.block_masks(idx, CELLS, WINDOW, bf, core, drop_self_slot0=True)
            mcore = core
        b, nb, et, p = masks.shape
        ins = (torch.randn((b, nb, p, c), generator=g, device=dev) * SCALES[0],
               torch.randn((b, nb, et, c), generator=g, device=dev) * SCALES[1],
               torch.randn((c, q), generator=g, device=dev) * SCALES[2],
               torch.randn((c, q), generator=g, device=dev) * SCALES[2])
        ins = tuple(t.to(bf) for t in ins)
        want = FK.boundary_reference(masks, *ins)
        n_bytes = (sum(t.numel() * t.element_size() for t in (masks,) + ins)
                   + sum(t.numel() * t.element_size() for t in want[:1])
                   + want[0].numel() // c * q * 4 + b * nb * p * q * 4)
        flops = 2.0 * b * nb * (et * p * c + 2 * et * c * q + et * p * q)
        bound_ms = max(n_bytes / H100_BYTES_PER_S, flops / H100_BF16_TC_OPS) * 1e3
        bound_by = "bytes" if n_bytes / H100_BYTES_PER_S >= flops / H100_BF16_TC_OPS \
            else "operations"
        tilings = {}
        if "kernel" in libs or any(k in libs for k in TEXT_VARIANTS):
            tilings["chosen"] = FK.fused_tiling(p, c, q, smem_limit)
            chosen = tilings["chosen"]
            forced = [(f"k{k}", {"cluster": k}) for k in FK.CLUSTERS if k != chosen.cluster]
            if chosen.rows == 32:
                forced.append(("R16", {"cluster": chosen.cluster, "rows": 16}))
            for name, kw in forced:
                try:
                    tilings[name] = FK.fused_tiling(p, c, q, smem_limit, **kw)
                except ValueError as e:
                    print(f"  {label}: {name} does not fit: {e}", flush=True)
        calls = calls_at(libs, masks, ins, tilings, smem_limit)
        recs = {}
        for name, entry in calls.items():
            if entry is None:
                recs[name] = {"refused": True}
                print(f"  {label}: {name} refuses the shape", flush=True)
                continue
            call, outs = entry
            call()
            torch.cuda.synchronize()
            rec = recs[name] = {"events_ms": []}
            if isinstance(outs, tuple) and outs and outs[0] == "ring":
                rec["every_byte_once"] = xor_all(outs[1]) == xor_all(outs[2].view(torch.int32))
                if not rec["every_byte_once"]:
                    failed.append((label, name))
            elif outs is not None:
                err, worst = within(outs, want)
                first = [o.clone() for o in outs]
                call()
                torch.cuda.synchronize()
                same = all(torch.equal(x0, x1) for x0, x1 in zip(first, outs))
                rec.update(max_abs_err=err, worst=worst, same_across_launches=same)
                if worst > 0 or not same:
                    failed.append((label, name))
        order = [n for n in calls if calls[n] is not None]
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                recs[name]["events_ms"].append(cuda_ms(calls[name][0]))
        print(f"\n{label} masks {tuple(masks.shape)} bf16, C={c} q={q}: bound "
              f"{bound_ms:.4f} ms ({bound_by}; {n_bytes / 1e9:.3f} GB, "
              f"{flops / 1e9:.1f} GFLOP) [{smi}]", flush=True)
        for name in order:
            v = recs[name]
            v["device_ms"] = device_ms(calls[name][0])
            v["ms"] = min(v["events_ms"])
            v["share"] = bound_ms / v["device_ms"]
            ev = " / ".join(f"{t:.4f}" for t in v["events_ms"])
            extra = ""
            if "worst" in v:
                extra = (f", max|err| {v['max_abs_err']:.3e} (worst err - tol "
                         f"{v['worst']:.3e}), same across launches "
                         f"{v['same_across_launches']}")
            if "every_byte_once" in v:
                rate = masks.numel() * 2 / v["device_ms"] / 1e9
                extra = f", {rate:.3f} TB/s of mask, every byte once {v['every_byte_once']}"
            print(f"  {name:<58} events {ev} ms, device {v['device_ms']:.4f} ms, "
                  f"share {v['share']:.3f}{extra}", flush=True)
        result["shapes"][label] = {"masks": list(masks.shape), "c": c, "q": q,
                                   "bound_ms": bound_ms, "bound_by": bound_by,
                                   "bytes": n_bytes, "flops": flops,
                                   "tilings": {k: t._asdict() for k, t in tilings.items()},
                                   "variants": recs}
        del want, ins
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "fused_variants.json"), "w") as f:
        json.dump(result, f)
    if failed:
        print(f"FAILED (out of tolerance, not identical across launches, or a "
              f"ring byte lost): {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
