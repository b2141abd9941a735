#!/usr/bin/env python3
"""Time kernel H's mask ring alone on one CUDA card: the int8 / int4 route
masks streamed through shared memory with no products, by a cp.async ring
and by a TMA ring, beside a plain torch read of the same mask.

    python3 scripts/torch_mask_ring.py [--out_dir DIR]

Builds scripts/mask_ring.cu with nvcc (csrc/tma_ring.cuh beside kernel
H's) into build/.  At the int8 route's shapes -- 32^3 b4, K 14, window 2,
core (4, 8, 8): masks (4, 128, 3328, 1152) int8 (1.96 GB) and packed int4
(576 bytes a row, 0.98 GB), random bytes from a fixed seed -- it times
each ring (rows per warp x consumer warps, stage bytes, stages) of the
list below:
  * cp.async: every warp copies and consumes, one CTA per tile (as kernel
    I) or one per SM walking tiles;
  * TMA: a producer warp, full/empty mbarriers, one CTA per SM walking
    tiles (or one per tile), with L2 promotion none / 128 / 256 bytes and
    an evict-first or evict-normal policy;
and checks that every mask byte arrived once (an XOR of the words every
consumer read against the XOR of the mask).  Beside them, in the same
call: torch's int64 sum over the mask (a plain read) and its copy.  CUDA
events, ms per call over 10 calls after 2 warm-up; rates in TB/s of mask
bytes.  Prints each line, and writes them as JSON with the card's name
and power limit to <out_dir>/mask_ring.json.  Fails without a card.
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

SHAPE = (4, 128, 3328, 1152)           # B, NB, ET, P of the int8 route
# (label, rows per warp, consumer warps, stage bytes, stages): kernel H's
# rings at C <= 16 and C 64 and a wider variant of each
RINGS = (
    ("C<=16 256x7 32B x3", 256, 7, 32, 3),
    ("C<=16 256x4 64B x3", 256, 4, 64, 3),
    ("C<=16 128x13 64B x2", 128, 13, 64, 2),
    ("C64 64x8 64B x4", 64, 8, 64, 4),
    ("C64 64x8 128B x3", 64, 8, 128, 3),
)
# (label, tma, persistent, L2 promotion bytes, evict_first)
VARIANTS = (
    ("cp.async, CTA per tile", 0, False, 0, 1),
    ("cp.async, CTA per SM", 0, True, 0, 1),
    ("TMA, CTA per tile, promo 128, evict-first", 1, False, 128, 1),
    ("TMA, promo none, evict-first", 1, True, 0, 1),
    ("TMA, promo 128, evict-first", 1, True, 128, 1),
    ("TMA, promo 256, evict-first", 1, True, 256, 1),
    ("TMA, promo 128, evict-normal", 1, True, 128, 0),
    ("TMA, promo 256, evict-normal", 1, True, 256, 0),
)


def load_library():
    src = os.path.join(HERE, "scripts", "mask_ring.cu")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "libmask_ring.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise build.KernelBuildError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(out)
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mask_ring.argtypes = [P, P, L, I, I, I, I, I, I, I, I, I, I, P]
    lib.sm_count.argtypes = [I]
    return lib


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


def xor_all(words: torch.Tensor) -> int:
    """XOR of every int32 of a flat tensor (a halving tree on the card)."""
    w = words.flatten()
    while w.numel() > 1:
        if w.numel() % 2:
            w = torch.cat([w, w.new_zeros(1)])
        h = w.numel() // 2
        w = w[:h] ^ w[h:]
    return int(w.item()) & 0xFFFFFFFF


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mask_ring: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    lib = load_library()
    sms = lib.sm_count(0)
    stream = build.stream(0)
    b, nb, et, p = SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "shape": SHAPE, "rows": []}
    for mdt, rb in (("int8", p), ("int4", p // 2)):
        masks = torch.randint(0, 256, (b, nb, et, rb), generator=g, device=dev,
                              dtype=torch.uint8)
        nbytes = masks.numel()
        want = xor_all(masks.view(torch.int32))
        as64 = masks.view(torch.int64)
        for label, fn in (("torch int64 sum", lambda: as64.sum()),
                          ("torch copy", lambda: masks.clone())):
            ms = cuda_ms(fn)
            tbs = nbytes / ms / 1e9
            print(f"{mdt} {label}: {ms:.4f} ms, {tbs:.3f} TB/s")
            result["rows"].append({"mask": mdt, "ring": label, "ms": ms, "tb_s": tbs})
        for ring, rpw, warps, kw, stages in RINGS:
            rows = rpw * warps
            tiles = b * nb * -(-et // rows)
            for vlabel, tma, persistent, promo, evict in VARIANTS:
                grid = sms if persistent else 0
                nthreads = (warps + tma) * 32
                out = torch.zeros((min(tiles, grid) if grid else tiles) * nthreads,
                                  dtype=torch.int32, device=dev)

                def run():
                    err = lib.mask_ring(masks.data_ptr(), out.data_ptr(), b * nb, et,
                                        rb, rpw, warps, kw, stages, tma, grid,
                                        promo, evict, stream)
                    if err:
                        raise RuntimeError(f"mask_ring failed: cudaError_t {err}")

                run()
                torch.cuda.synchronize()
                ok = xor_all(out) == want
                ms = cuda_ms(run)
                tbs = nbytes / ms / 1e9
                print(f"{mdt} {ring} | {vlabel}: {ms:.4f} ms, {tbs:.3f} TB/s, "
                      f"every byte once {ok}")
                result["rows"].append({"mask": mdt, "ring": ring, "variant": vlabel,
                                       "ms": ms, "tb_s": tbs, "checked": ok})
                if not ok:
                    break
        del masks, as64
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "mask_ring.json"), "w") as f:
        json.dump(result, f)
    return 0 if all(r.get("checked", True) for r in result["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
