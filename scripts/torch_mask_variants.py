#!/usr/bin/env python3
"""Variant timings of kernel H (csrc/mask_kernels.cu, mask_gather_kernel)
on one CUDA card: what its ring, its products, its widening, its patch
copies and its output stores each cost, and the configurations it chose
against their neighbours.

    python3 scripts/torch_mask_variants.py [--widths 1,3,16,32,64] [--out_dir DIR]

Each variant is the committed source with a few lines replaced (VARIANTS
below), built with nvcc into build/ (all builds at once) and called
through the kernel's C entry with a tiling that matches its configuration.
A variant that does less work gives wrong results: these builds are for
timing only, and the kernel itself is the first row.  At the int8 route's
shapes -- 32^3 b4, K 14, window 2, core (4, 8, 8): masks (4, 128, 3328,
1152) int8 and packed int4 with values in {-1, 0, 1} from a fixed seed --
each variant is timed at every width, in two rounds over all variants
(CUDA events, 10 calls after 2 warm-up; the lower of the two rounds).
Prints a table with the card's name and power limit, and writes it as JSON
to <out_dir>/mask_variants.json.  Fails without a card or where a
replaced line is no longer in the source.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from nbody_tpu_torch.ops.kernels import build  # noqa: E402
from nbody_tpu_torch.ops.kernels import mask_kernels as MK  # noqa: E402

SHAPE = (4, 128, 3328, 1152)           # B, NB, ET, P of the int8 route

_MMA = "mma_bf16(acc[mi][nj], a, b[nj][0], b[nj][1]);"
# keeps the fragments live at the cost of a few ALU ops
_NO_MMA = ("acc[mi][nj][0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ "
           "b[nj][0] ^ b[nj][1]) & 0x3f800000u);")
_WIDEN = "gather_a_frag<kInt4>(w[mi][0], w[mi][1], ks, a);"
_NO_WIDEN = "a[0] = w[mi][0]; a[1] = w[mi][1]; a[2] = ~w[mi][0]; a[3] = ~w[mi][1];"
_PATCHES = ("        const int p0 = st * kKP;\n        if (vec_x) {",
            "        } else {\n          // rows that are not 16-byte aligned")
_NO_PATCHES = ("        const int p0 = st * kKP;\n        if (p0 < 0) {",
               "        } else if (p0 < 0) {\n          // rows that are not 16-byte aligned")
_BODY = "      if (active) {\n        const unsigned char* ms"
_NO_BODY = "      if (active && p < 0) {\n        const unsigned char* ms"
_STORES = "    if (!active) continue;\n"
_NO_STORES = "    if (!active || p > 0) continue;\n"
_POLICY = "createpolicy.fractional.L2::evict_normal.b64"
_CFG = {1: "  return nt == 1   ? GatherCfg{128, 2, 13}",
        2: "         : nt == 2 ? GatherCfg{128, 3, 8}",
        8: "                   : GatherCfg{64, 4, 7};"}

# (label, [(old, new), ...], {nt: (rows_per_warp, stages, max_warps)})
VARIANTS = (
    ("kernel H as committed", [], {}),
    ("mask boxes evict-first", [(_POLICY, _POLICY.replace("normal", "first"))], {}),
    ("no output stores", [(_STORES, _NO_STORES)], {}),
    ("no products", [(_MMA, _NO_MMA)], {}),
    ("no products, no widening", [(_MMA, _NO_MMA), (_WIDEN, _NO_WIDEN)], {}),
    ("no patch copies", list(zip(_PATCHES, _NO_PATCHES)), {}),
    ("ring only (no consumer work, no stores)",
     [(_BODY, _NO_BODY), (_STORES, _NO_STORES)], {}),
    ("C <= 8 as C 16: 8 warps, 3 stages",
     [(_CFG[1], "  return nt == 1   ? GatherCfg{128, 3, 8}")], {1: (128, 3, 8)}),
    ("C 16 as C <= 8: 13 warps, 2 stages",
     [(_CFG[2], "         : nt == 2 ? GatherCfg{128, 2, 13}")], {2: (128, 2, 13)}),
    ("C 64: 8 warps",
     [(_CFG[8], "                   : GatherCfg{64, 4, 8};")], {8: (64, 4, 8)}),
)


def build_variant(i, label, patches):
    """Write, compile and load variant i; returns the ctypes library."""
    src = open(os.path.join(build.CSRC_DIR, "mask_kernels.cu")).read()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"variant {label!r}: line not in the source: {old!r}")
        src = src.replace(old, new)
    d = os.path.join(os.path.dirname(build.BUILD_DIR), "mask_variants", str(i))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "mask_kernels.cu"), "w") as f:
        f.write(src)
    shutil.copy(os.path.join(build.CSRC_DIR, "tma_ring.cuh"), d)
    out = os.path.join(d, "libmask_variant.so")
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", out,
                           os.path.join(d, "mask_kernels.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise build.KernelBuildError(f"variant {label!r}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.mask_dot_gather.argtypes = list(MK._SIGNATURES["mask_dot_gather"])
    lib.mask_dot_gather.restype = ctypes.c_int
    return lib


def tiling(et, c, int4, cfgs):
    """MK.gather_tiling with a variant's configurations per nt."""
    tl = MK.gather_tiling(et, c, int4)
    if tl.nt not in cfgs:
        return tl
    rw, stages, max_warps = cfgs[tl.nt]
    warps, tiles = MK._split_rows(et, rw, max_warps)
    rows_p = MK.GATHER_SPAN * (2 if int4 else 1)
    smem = 1024 + stages * (warps * rw * MK.GATHER_SPAN
                            + rows_p * MK.gather_ldx(tl.nt) * 2 + 16)
    return MK.GatherTiling(tl.nt, rw, warps, tiles, stages, smem)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default="1,3,16,32,64")
    ap.add_argument("--out_dir", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mask_variants: no CUDA card", file=sys.stderr)
        return 1
    widths = [int(w) for w in args.widths.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = list(ex.map(lambda a: build_variant(a[0], *a[1][:2]),
                           enumerate(VARIANTS)))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    b, nb, et, p = SHAPE
    m8 = torch.randint(-1, 2, SHAPE, generator=g, device=dev, dtype=torch.int8)
    masks = {"int8": m8, "int4": MK.pack_int4(m8)}
    pats = {c: torch.randn((b, nb, p, c), generator=g, device=dev).to(torch.bfloat16)
            for c in widths}
    stream = build.stream(0)
    ms = {}
    for _ in range(2):
        for (label, _, cfgs), lib in zip(VARIANTS, libs):
            for mdt, m in masks.items():
                int4 = mdt == "int4"
                for c in widths:
                    x, tl = pats[c], tiling(et, c, int4, cfgs)
                    out = torch.empty((b, nb, et, c), device=dev)

                    def run():
                        err = lib.mask_dot_gather(
                            m.data_ptr(), x.data_ptr(), out.data_ptr(), b * nb, et,
                            p, c, int(int4), tl.nt, tl.rows_per_warp, tl.warps,
                            tl.row_tiles, tl.stages, tl.smem_bytes, 0, stream)
                        if err:
                            raise RuntimeError(f"{label}: cudaError_t {err}")

                    t = cuda_ms(run)
                    key = f"{label} | {mdt} C={c}"
                    ms[key] = min(ms.get(key, t), t)
    print(smi)
    cols = [f"{mdt} C{c}" for mdt in masks for c in widths]
    print("variant | " + " | ".join(cols))
    for label, _, _ in VARIANTS:
        print(label + " | " + " | ".join(
            f"{ms[f'{label} | {mdt} C={c}']:.4f}" for mdt in masks for c in widths))
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "mask_variants.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                   "shape": SHAPE, "ms": ms}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
