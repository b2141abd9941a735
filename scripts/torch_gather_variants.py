#!/usr/bin/env python3
"""Variant timings of kernels D and F (csrc/block_kernels.cu,
patch_gather_kernel) on one CUDA card, beside the TMA-fed ring of patch
tiles they were measured against (scripts/gather_ring.cu) and, given a
parent tree, the parent's gather kernel.

    python3 scripts/torch_gather_variants.py [--parent DIR]
        [--widths 1,3,6,9,16,32,64] [--rounds 2] [--only BUILDS] [--out_dir DIR]

Shapes: the 32^3 block route's (batch 4, core (4,4,8), P 768, ET 1,792:
kernel F) and the 64^3 index route's (batch 1, core (4,8,8), P 1,152, ET
3,328, and the test core (8,8,8), P 1,728, ET 6,656: kernel D), with the
positions of a lattice kNN graph (K 14, window 2) of a synthetic cube and
bf16 patches from a fixed seed, as the routes run them.  Builds (--only
takes a comma-separated subset; all by default):
  - direct: the committed kernel, with the tiling gather_tiling chooses;
  - direct-stcs: the committed source with st.global.cs stores;
  - ring: scripts/gather_ring.cu with ring_tiling's tiling (whole C per
    unit where two stages fit), and with the widest C tile of which three
    stages fit one CTA, and with one CTA per SM;
  - ring-stcs: the ring with st.global.cs stores;
  - ring-alone: the ring with no output stores (timing only: its output is
    wrong);
  - parent: DIR/nbody_tpu_torch/csrc/block_kernels.cu of a tree from
    before this design (one CTA per (block, C tile) staging its tile in
    shared memory, C split over 113 KB tiles).
Every source is built with nvcc into build/gather_variants, all at once.
Each variant's output is compared with the plain gather (bit-equal, except
ring-alone); its time per call is taken with CUDA events (20 calls after 3
warm-up) in `rounds` rounds over all variants, in turns (forward, then
backward, ...), and on the device alone (torch.profiler, 10 calls); the
bound is the bytes of positions, patches and output over 3.35 TB/s.
Prints a table per shape with the card's name and power limit, and writes
everything as JSON to <out_dir>/gather_variants.json.  Fails without a card
or where a variant is not bit-equal.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from nbody_tpu_torch.ops.kernels import block_kernels as BK  # noqa: E402
from nbody_tpu_torch.ops.kernels import build  # noqa: E402

K, WINDOW = 14, 2
H100_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet
SHAPES = {                       # label: (batch, cells, core, drop_self)
    "F 32^3 b4 core (4,4,8)": (4, 32, (4, 4, 8), False),
    "D 64^3 b1 core (4,8,8)": (1, 64, (4, 8, 8), True),
    "D 64^3 b1 core (8,8,8)": (1, 64, (8, 8, 8), True),
}
_STCS = ("__stcs(reinterpret_cast<int4*>({dst}), "
         "*reinterpret_cast<const int4*>(&u));")
DIRECT_SRC = "nbody_tpu_torch/csrc/block_kernels.cu"
RING_SRC = "scripts/gather_ring.cu"
# build: (source, label, [(line, replacement), ...])
TEXT_VARIANTS = {
    "direct-stcs": (DIRECT_SRC, "direct, st.global.cs stores",
                    [("      ov[i] = u;", "      " + _STCS.format(dst="ov + i"))]),
    "ring-stcs": (RING_SRC, "ring, st.global.cs stores", [
        ("      *reinterpret_cast<U*>(oblk + (long long)e * r.c + c0 + k * V) = u;",
         "      " + _STCS.format(dst="oblk + (long long)e * r.c + c0 + k * V")),
        ("      ov[i] = u;", "      " + _STCS.format(dst="ov + i"))]),
    "ring-alone": (RING_SRC, "ring alone (no stores; timing only)", [
        ("      store_unit<T, kRound>(r, smem + s * r.stage_bytes, out, blk, t * r.ct, tid);",
         "      if (r.p < 0) store_unit<T, kRound>(r, smem + s * r.stage_bytes, out, "
         "blk, t * r.ct, tid);")]),
}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ENTRIES = {      # C entry of each source: (name, argument types)
    DIRECT_SRC: ("block_select_gather", BK._SIGNATURES["block_select_gather"]),
    RING_SRC: ("ring_gather", (_P, _P, _P, _L) + (_I,) * 12 + (_P,)),
    "parent": ("block_select_gather", (_P, _P, _P, _L) + (_I,) * 8 + (_P,)),
}
PARENT_SMEM = 113 * 1024         # the parent's GATHER_SMEM

# the ring's shared memory on an H100 (scripts/gather_ring.cu: make_ring)
SMEM_OPTIN = 232_448             # dynamic shared memory one CTA may opt in to
SM_SMEM = 233_472                # shared memory of one SM, 1 KB kept per CTA
CTA_RESERVED = 1024
MAX_STAGES = 4
MAX_CTAS = 4                     # CTAs per SM (288 threads each)
_SMEM_ALIGN = 128                # kSmemAlign: a stage's base and size
_MAX_BOX_ROWS = 256              # kMaxBoxRows: rows of a tensor-map box


class RingTiling(NamedTuple):
    """The ring for one launch: units of `ct` channels of a block, `stages`
    stages per CTA, `ctas` CTAs per SM; a C-tiled unit's patch tile comes as
    `boxes` tensor-map boxes of `box_rows` rows.  A stage holds the tile
    (`tile_rows` x ct elements) and, at byte `pos_off`, the unit's ET
    positions; stages lie `stage_bytes` apart; a CTA takes `smem_bytes`."""
    ct: int
    stages: int
    ctas: int
    boxes: int
    box_rows: int
    tile_rows: int
    pos_off: int
    stage_bytes: int
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ring_layout(p, et, c, elem, ct, stages, ctas) -> RingTiling:
    """The ring's layout for a C tile, stages and CTAs per SM (make_ring
    checks the same): a C-tiled unit reads ceil(P / 256) boxes of rows
    rounded up to 8, each landing at a 128-byte boundary."""
    if ct < c:
        boxes = max(1, -(-p // _MAX_BOX_ROWS))
        box_rows = _round_up(-(-p // boxes), 8)
        rows = boxes * box_rows
    else:
        boxes, box_rows, rows = 1, 1, p
    pos_off = _round_up(rows * ct * elem, 16)
    stage = _round_up(pos_off + 4 * et, _SMEM_ALIGN)
    return RingTiling(ct, stages, ctas, boxes, box_rows, rows, pos_off, stage,
                      _SMEM_ALIGN + stages * stage + 16 * stages)


def _c_tile(c, elem, tiles):
    grain = 16 // elem if c * elem % 16 == 0 else 1
    return c if tiles == 1 else min(c, _round_up(-(-c // tiles), grain))


def ring_tiling(p, et, c, elem) -> RingTiling:
    """The whole of C per unit where two stages of it fit, else the fewest
    equal C tiles of which two fit; then as many CTAs per SM as hold two
    stages each (MAX_CTAS at most), and as many stages as each CTA's share
    holds (MAX_STAGES at most)."""
    for tiles in range(1, c + 1):
        two = ring_layout(p, et, c, elem, _c_tile(c, elem, tiles), 2, 1)
        if two.smem_bytes <= SMEM_OPTIN:
            break
    ctas = max(1, min(MAX_CTAS, SM_SMEM // (two.smem_bytes + CTA_RESERVED)))
    share = min(SMEM_OPTIN, SM_SMEM // ctas - CTA_RESERVED)
    stages = max(s for s in range(2, MAX_STAGES + 1)
                 if ring_layout(p, et, c, elem, two.ct, s, ctas).smem_bytes <= share)
    return ring_layout(p, et, c, elem, two.ct, stages, ctas)


def ring_three_stages(p, et, c, elem):
    """The widest C tile of which three stages fit one CTA."""
    for tiles in range(1, c + 1):
        tl = ring_layout(p, et, c, elem, _c_tile(c, elem, tiles), 3, 1)
        if tl.smem_bytes <= SMEM_OPTIN:
            return tl
    return None


def ring_one_cta(p, et, c, elem):
    """ring_tiling's C tile with one CTA per SM and as many stages as fit."""
    ct = ring_tiling(p, et, c, elem).ct
    stages = max(s for s in range(2, MAX_STAGES + 1)
                 if ring_layout(p, et, c, elem, ct, s, 1).smem_bytes <= SMEM_OPTIN)
    return ring_layout(p, et, c, elem, ct, stages, 1)


def parent_tiling(p: int, c: int):
    """(ct, vec) as the parent's wrapper chose them for bf16 on aligned
    buffers: the widest vector dividing C, C split into the fewest equal
    tiles of at most 113 KB."""
    vec = next(nb // 2 for nb in (16, 8, 4, 2) if c % (nb // 2) == 0)
    cv = c // vec
    tiles = -(-cv // max(1, PARENT_SMEM // (p * 2 * vec)))
    return -(-cv // tiles) * vec, vec


def _build(source: str, label: str, out_dir: str, replace=()) -> ctypes.CDLL:
    """nvcc of `source` (a path in the repo, or a parent tree's absolute
    path) with lines replaced, into out_dir; its C entry's types declared."""
    path = source if os.path.isabs(source) else os.path.join(HERE, source)
    src = open(path).read()
    for old, new in replace:
        if old not in src:
            raise RuntimeError(f"{label}: line not in {source}: {old!r}")
        src = src.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    copy = os.path.join(out_dir, os.path.basename(path))
    with open(copy, "w") as f:
        f.write(src)
    lib_path = os.path.join(out_dir, "libvariant.so")
    # the original's directory on the include path keeps its includes
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", os.path.dirname(path),
                           "-o", lib_path, copy], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise build.KernelBuildError(f"{label}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    entry, types = ENTRIES["parent" if os.path.isabs(source) else source]
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = list(types), ctypes.c_int
    return lib


def variant_calls(libs, pos, pat, want):
    """{label: (call, its output buffer, its tiling)} at one shape."""
    b, nb, p, c = pat.shape
    et = pos.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}

    def add(label, fn, tiling):
        out = torch.empty_like(want)
        calls[label] = (lambda: build.check_launch(
            fn(pat.data_ptr(), pos.data_ptr(), out.data_ptr()), label), out, tiling)

    for key, lib in libs.items():
        if key in ("direct", "direct-stcs"):
            tl = BK.gather_tiling(et, c, 2, True, True)
            label = "direct" if key == "direct" else TEXT_VARIANTS[key][1]
            add(label, lambda pt, ps, o, lib=lib, tl=tl: lib.block_select_gather(
                pt, ps, o, b * nb, p, et, c, tl.path, tl.chunks, 1, 0, 0, stream),
                tl._asdict())
        elif key == "parent":
            ct, vec = parent_tiling(p, c)
            add("parent", lambda pt, ps, o, lib=lib, ct=ct, vec=vec: lib.block_select_gather(
                pt, ps, o, b * nb, p, et, c, ct, vec, 1, 0, 0, stream),
                {"ct": ct, "vec": vec})
        else:
            tilings = {"ring" if key == "ring" else TEXT_VARIANTS[key][1]:
                       ring_tiling(p, et, c, 2)}
            if key == "ring":
                tilings["ring, 3 stages, 1 CTA/SM"] = ring_three_stages(p, et, c, 2)
                tilings["ring, 1 CTA/SM"] = ring_one_cta(p, et, c, 2)
            for label, tl in tilings.items():
                if tl is not None:
                    add(label, lambda pt, ps, o, lib=lib, tl=tl: lib.ring_gather(
                        pt, ps, o, b * nb, p, et, c, tl.ct, tl.stages, tl.ctas,
                        tl.boxes, tl.box_rows, tl.smem_bytes, 1, 0, 0, stream),
                        tl._asdict())
    return calls


def cuda_ms(fn, iters=20, warmup=3):
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
    ap.add_argument("--parent", default=None)
    ap.add_argument("--widths", default="1,3,6,9,16,32,64")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default=None)
    ap.add_argument("--out_dir", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gather_variants: no CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.data.dataset import features_from_raw
    from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import topk_kernels as T

    widths = [int(w) for w in args.widths.split(",")]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}", flush=True)

    vdir = os.path.join(os.path.dirname(build.BUILD_DIR), "gather_variants")
    jobs = {"direct": BK.library,
            "ring": lambda: _build(RING_SRC, "ring", os.path.join(vdir, "ring"))}
    for key, (source, label, replace) in TEXT_VARIANTS.items():
        jobs[key] = lambda key=key, source=source, label=label, replace=replace: _build(
            source, label, os.path.join(vdir, key), replace)
    if args.parent:
        jobs["parent"] = lambda: _build(
            os.path.join(os.path.abspath(args.parent), DIRECT_SRC), "parent",
            os.path.join(vdir, "parent"))
    if args.only:
        jobs = {k: fn for k, fn in jobs.items() if k in args.only.split(",")}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        libs = {k: f.result() for k, f in futures.items()}
    print(f"built: {sorted(libs)}", flush=True)
    for ln in build.BUILD_INFO.get("block_kernels", {}).get("log", "").splitlines():
        if "registers" in ln or "spill" in ln or "entry function" in ln:
            print(f"  ptxas: {ln.strip()}")

    def graph(batch, cells):
        x = torch.from_numpy(features_from_raw(synthetic_raw_cubes(batch, cells, seed=0),
                                               include_velocity=False)).to(dev)
        pn = torch.remainder((x[..., :3] + 2.0 * cells + x[..., 3:6]) / (4.0 * cells), 1.0)
        return T.lattice_knn(pn.contiguous(), K, cells, WINDOW)

    graphs = {}
    g = torch.Generator(device=dev).manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "shapes": {}}
    for label, (batch, cells, core, drop) in SHAPES.items():
        if (batch, cells) not in graphs:
            graphs[(batch, cells)] = graph(batch, cells)
        plan = blocked.block_index_plan(graphs[(batch, cells)], cells, WINDOW, core,
                                        drop_self_slot0=drop)
        pos = plan.pos
        p = blocked.patch_size(cells, WINDOW, core)
        b, nb, et = pos.shape
        rows = result["shapes"][label] = {}
        for c in widths:
            pat = torch.randn((b, nb, p, c), generator=g, device=dev).to(torch.bfloat16)
            want = BK.select_gather_plain(pos, pat)
            n_bytes = pos.numel() * 4 + pat.numel() * 2 + want.numel() * 2
            bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
            calls = variant_calls(libs, pos, pat, want)
            recs = {}
            for name, (call, out, tiling) in calls.items():
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                equal = None if "timing only" in name else torch.equal(out, want)
                recs[name] = {"tiling": tiling, "bit_equal": equal, "events_ms": []}
            order = list(calls)
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    recs[name]["events_ms"].append(cuda_ms(calls[name][0]))
            for name in order:
                recs[name]["device_ms"] = device_ms(calls[name][0])
                recs[name]["ms"] = min(recs[name]["events_ms"])
                recs[name]["share"] = bound_ms / recs[name]["device_ms"]
            rows[str(c)] = {"bound_ms": bound_ms, "bytes": n_bytes, "variants": recs}
            print(f"\n{label} ({b}, {nb}, {et}) P={p} C={c} bf16: bound {bound_ms:.4f} ms "
                  f"({n_bytes / 1e6:.1f} MB) [{smi}]", flush=True)
            for name in order:
                v = recs[name]
                ev = " / ".join(f"{x:.4f}" for x in v["events_ms"])
                print(f"  {name:<40} events {ev} ms, device {v['device_ms']:.4f} ms, "
                      f"share {v['share']:.3f}, bit-equal {v['bit_equal']}", flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "gather_variants.json"), "w") as f:
        json.dump(result, f)
    bad = [(s, c, n) for s, rows in result["shapes"].items() for c, row in rows.items()
           for n, v in row["variants"].items() if v["bit_equal"] is False]
    if bad:
        print(f"NOT bit-equal: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
