#!/usr/bin/env python3
"""Where kernel J (csrc/fused_kernels.cu) spends a tile, on one CUDA card.

    python3 scripts/torch_fused_sections.py [--shapes LABELS] [--out_dir DIR]

Builds a copy of the committed source with clock64 timers around each
section of the tile loop, and runs it once at each shape (the shapes,
masks and inputs of scripts/torch_fused_variants.py).  Consumer sections
are timed by thread 0 (the first consumer warp), chain sections by the
first chain warp's lane 0; each adds its cycles to a per-CTA counter
(one atomic add per section and tile, which slows the call a little).
Prints, for the first two CTAs, cycles per tile of the CTA's walk (the
copy counts the tiles):
  consumers: the wait for the stage (full), the M . patches products, the
    partials' stores, the first barrier, the sum over the warps, the
    proxy fence, the second barrier, the wait for hw, the M^T . hw
    products;
  chain: the wait for the cluster's sums, the element loop (sums, a_edge,
    relu, act and the act tile), the weight products with h1 and hw, the
    fence and barrier before hw's copies.
Writes them as JSON with the card's name and power limit to
<out_dir>/fused_sections.json.  Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from nbody_tpu_torch.ops.kernels import build  # noqa: E402
from nbody_tpu_torch.ops.kernels import fused_kernels as FK  # noqa: E402

KERNEL_SRC = os.path.join(HERE, "nbody_tpu_torch", "csrc", "fused_kernels.cu")
SHAPES = {"(4,8,8) C32 q32": ((4, 8, 8), 32, 32),
          "(4,8,8) C32 q64": ((4, 8, 8), 32, 64),
          "(4,8,8) C16 q3": ((4, 8, 8), 16, 3)}
SECTIONS = ("full wait", "M.patches", "partial stores", "barrier 1", "warp sum",
            "proxy fence", "barrier 2", "hw wait", "M^T.hw",
            "chain: sums wait", "chain: element loop", "chain: weight products",
            "chain: fence + barrier")
# (text of the committed source, the text with timers): TS(n) reads the
# clock, ACC(slot, a, b) adds the cycles from TS(a) to TS(b) to the slot
TIMERS = (
    ("namespace {\n\ntypedef __nv_bfloat16 bf16;",
     "__device__ unsigned long long g_sections[1024][16];\n"
     "#define TS(n) long long _t##n = clock64();\n"
     "#define ACC(slot, a, b) if (tid == 0 || (warp == W && lane == 0)) "
     "atomicAdd(&g_sections[blockIdx.x][slot], (unsigned long long)(_t##b - _t##a));\n"
     "namespace {\n\ntypedef __nv_bfloat16 bf16;"),
    ("      mbar_wait(full0 + 8 * s, (uint32_t)((i1 / S) & 1));\n      float eacc",
     "      TS(0) mbar_wait(full0 + 8 * s, (uint32_t)((i1 / S) & 1)); TS(1)\n      float eacc"),
    ("      float* part = reinterpret_cast<float*>(smem + L.partial) + warp * R * LDE;",
     "      TS(2) ACC(0, 0, 1) ACC(1, 1, 2)\n"
     "      float* part = reinterpret_cast<float*>(smem + L.partial) + warp * R * LDE;"),
    ("      named_sync(1, nthreads);\n      float* __restrict__ eo",
     "      TS(3) named_sync(1, nthreads); TS(4) ACC(2, 2, 3) ACC(3, 3, 4)\n"
     "      float* __restrict__ eo"),
    ("      fence_proxy_async();\n      named_sync(1, nthreads);",
     "      TS(5) fence_proxy_async(); TS(6)\n      named_sync(1, nthreads);\n"
     "      TS(7) ACC(4, 4, 5) ACC(5, 5, 6) ACC(6, 6, 7)"),
    ("      mbar_wait(hwfull0 + 8 * (int)(i & 1), (uint32_t)((i >> 1) & 1));",
     "      TS(8) mbar_wait(hwfull0 + 8 * (i & 1), (uint32_t)((i >> 1) & 1)); TS(9) ACC(7, 8, 9)"),
    ("      if (lane == 0) mbar_arrive(empty0 + 8 * s);",
     "      TS(10) ACC(8, 9, 10)\n"
     "      if (tid == 0) atomicAdd(&g_sections[blockIdx.x][15], 1ull);\n"
     "      if (lane == 0) mbar_arrive(empty0 + 8 * s);"),
    ("      mbar_wait(efull0 + 8 * slot, (uint32_t)((i >> 1) & 1));",
     "      TS(20) mbar_wait(efull0 + 8 * slot, (uint32_t)((i >> 1) & 1)); TS(21) ACC(9, 20, 21)"),
    ("      bf16* hwo =", "      TS(22) ACC(10, 21, 22)\n      bf16* hwo ="),
    ("      // these rows of hw to every CTA of the cluster, one bulk copy each",
     "      TS(23) ACC(11, 22, 23)\n"
     "      // these rows of hw to every CTA of the cluster, one bulk copy each"),
    ("      if (cw == 0 && lane == 0) {",
     "      TS(24) ACC(12, 23, 24)\n      if (cw == 0 && lane == 0) {"),
)
READERS = '''
extern "C" int sections_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_sections, sizeof(g_sections));
}
extern "C" int sections_zero() {
  static unsigned long long zero[1024][16];
  return (int)cudaMemcpyToSymbol(g_sections, zero, sizeof(zero));
}
'''


def build_timed(out_dir: str) -> ctypes.CDLL:
    src = open(KERNEL_SRC).read()
    for old, new in TIMERS:
        if src.count(old) != 1:
            raise RuntimeError(f"text not once in {KERNEL_SRC}: {old!r}")
        src = src.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    copy = os.path.join(out_dir, "fused_kernels.cu")
    with open(copy, "w") as f:
        f.write(src + READERS)
    lib_path = os.path.join(out_dir, "lib.so")
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                           os.path.dirname(KERNEL_SRC), "-o", lib_path, copy],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise build.KernelBuildError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(lib_path)
    for entry, types in FK._SIGNATURES.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = list(types), ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default=None,
                    help="comma-separated labels of SHAPES (all by default)")
    ap.add_argument("--out_dir", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_sections: no CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.data.dataset import features_from_raw
    from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
    from nbody_tpu_torch.ops import blocked
    from nbody_tpu_torch.ops.kernels import topk_kernels as T

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    lib = build_timed(os.path.join(os.path.dirname(build.BUILD_DIR), "fused_sections"))
    x = torch.from_numpy(features_from_raw(synthetic_raw_cubes(4, 32, seed=0),
                                           include_velocity=False)).to(dev)
    pn = torch.remainder((x[..., :3] + 64.0 + x[..., 3:6]) / 128.0, 1.0)
    idx = T.lattice_knn(pn.contiguous(), 14, 32, 2)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "shapes": {}}
    labels = args.shapes.split(",") if args.shapes else list(SHAPES)
    bf = torch.bfloat16
    for label in labels:
        core, c, q = SHAPES[label]
        m = blocked.block_masks(idx, 32, 2, bf, core, drop_self_slot0=True)
        b, nb, et, p = m.shape
        g = torch.Generator(device=dev).manual_seed(0)
        ins = [(torch.randn(s, generator=g, device=dev) * sc).to(bf)
               for s, sc in (((b, nb, p, c), 1.0), ((b, nb, et, c), 0.01),
                             ((c, q), 0.1), ((c, q), 0.1))]
        tl = FK.fused_tiling(p, c, q, FK.max_smem(dev))
        outs = (torch.empty((b, nb, et, c), dtype=bf, device=dev),
                torch.empty((b, nb, et, q), device=dev),
                torch.empty((b, nb, p, q), device=dev))
        FK.launch(lib, tl, m, *ins, outs)
        torch.cuda.synchronize()
        build.check_launch(lib.sections_zero(), "sections_zero")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        FK.launch(lib, tl, m, *ins, outs)
        end.record()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (1024 * 16))()
        build.check_launch(lib.sections_read(buf), "sections_read")
        ms = start.elapsed_time(end)
        print(f"\n{label} {tl}: {ms:.3f} ms with timers; cycles per tile of the "
              f"CTA's walk [{smi}]", flush=True)
        rec = result["shapes"][label] = {"tiling": tl._asdict(), "ms": ms, "ctas": {}}
        for cta in (0, 1):
            tiles = buf[cta * 16 + 15]   # counted by the timed copy
            cycles = {n: buf[cta * 16 + j] / tiles for j, n in enumerate(SECTIONS)}
            cycles["tiles"] = tiles
            rec["ctas"][cta] = cycles
            print(f"  CTA {cta}: " + ", ".join(f"{n} {v:.0f}" for n, v in cycles.items()))
        del m, ins, outs
        torch.cuda.empty_cache()
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "fused_sections.json"), "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
