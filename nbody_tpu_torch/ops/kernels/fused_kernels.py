"""Kernel J: the fused layer-boundary op (one mask read for layer i's
gather and layer i+1's scatter), and its plain PyTorch version.

Replaces nbody_tpu/ops/pallas/fused_kernels.py : fused_boundary_dot
(``_fused_kernel``).  Per (batch, core block), with one-hot masks M
(ET, P) in bf16 or f32 (ops/blocked.block_masks):
  act = act(M . patches + a_edge)     (ET, C) in the patches' dtype
  h1  = act . W1                       (ET, q) f32
  s   = M^T . (act . W2)               (P, q)  f32, before the fold
with JAX's dtype chain (boundary_reference): the patches are cast to the
masks' dtype, every product accumulates in f32, the sum with a_edge is
taken in f32, the activations are cast to the weights' dtype before the
weight products, and act . W2 to the masks' dtype before the M^T product.

As in JAX, no model path runs it (fused_kernels.py:20-24); it is held
against boundary_reference and timed.  The CUDA kernel takes relu, the
only activation JAX uses; any other raises NotImplementedError on the
card.  bf16 masks run the tensor-core kernel, whose launch (a cluster of
CTAs a block, each with a slice of P; ``fused_tiling``) is chosen here and
checked in C; f32 masks run the CUDA-core form for exact f32 products.
The kernels are csrc/fused_kernels.cu (design note there); the wrapper
takes the plain version only for CPU tensors, and for a CUDA tensor
launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import build

FLOAT_DTYPES = (torch.float32, torch.bfloat16)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "fused_boundary": (_P,) * 8 + (_L,) + (_I,) * 18 + (_P,),
    "fused_boundary_f32": (_P,) * 8 + (_L,) + (_I,) * 9 + (_P,),
    "fused_max_smem": (_I,),
}
_MAX_SMEM = {}


def library():
    """The built and loaded csrc/fused_kernels.cu (compiled at first use)."""
    return build.load("fused_kernels", _SIGNATURES)


def max_smem(device: torch.device) -> int:
    """Dynamic shared memory one CTA may opt in to on the card."""
    if device.index not in _MAX_SMEM:
        _MAX_SMEM[device.index] = library().fused_max_smem(device.index)
    return _MAX_SMEM[device.index]


def boundary_reference(masks: torch.Tensor, patches: torch.Tensor,
                       a_edge: torch.Tensor, w1: torch.Tensor,
                       w2: torch.Tensor, act=torch.relu):
    """The unfused composition the kernel must match (plain PyTorch): f32
    matmuls of values rounded to JAX's dtypes (TF32 must be off on a
    card).  Returns (act_out, h1 f32, s f32)."""
    f32 = torch.float32
    m = masks.to(f32)
    e = torch.matmul(m, patches.to(masks.dtype).to(f32))
    e = act(e + a_edge.to(f32))
    eb = e.to(w1.dtype).to(f32)
    h1 = torch.matmul(eb, w1.to(f32))
    hw = torch.matmul(eb, w2.to(f32)).to(masks.dtype).to(f32)
    s = torch.matmul(m.transpose(-1, -2), hw)
    return e.to(patches.dtype), h1, s


def _check(masks, patches, a_edge, w1, w2):
    if masks.dim() != 4 or patches.dim() != 4 or a_edge.dim() != 4:
        raise ValueError("fused_boundary_dot: masks, patches and a_edge are "
                         "(B, NB, rows, cols)")
    b, nb, et, p = masks.shape
    c, q = patches.shape[3], w1.shape[-1]
    if (patches.shape != (b, nb, p, c) or a_edge.shape != (b, nb, et, c)
            or w1.shape != (c, q) or w2.shape != (c, q)):
        raise ValueError(
            f"fused_boundary_dot: bad shapes masks {tuple(masks.shape)}, "
            f"patches {tuple(patches.shape)}, a_edge {tuple(a_edge.shape)}, "
            f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    for t in (masks, patches, a_edge, w1, w2):
        if t.dtype not in FLOAT_DTYPES:
            raise ValueError(f"fused_boundary_dot takes float32 or bfloat16, "
                             f"got {t.dtype}")
        if t.device != masks.device:
            raise ValueError("fused_boundary_dot: tensors on several devices")
    if masks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_boundary_dot runs on cpu or cuda tensors, "
                         f"not {masks.device}")


# ---------------------------------------------------------------------------
# the tensor-core kernel's tiling (csrc/fused_kernels.cu mirrors it)
# ---------------------------------------------------------------------------

CTA_WARPS = 12        # warps of a CTA at most, 168 registers each (kMaxWarps)
MAX_WARPS = CTA_WARPS - 2   # consumer warps: one chain warp and the producer
BOX_COLS = 64         # mask columns of a TMA box (kBoxCols)
SMEM_ALIGN = 1024     # kSmemAlign
CLUSTERS = (1, 2, 4)


class FusedTiling(NamedTuple):
    """The bf16 kernel's launch for one shape: C and q in `nc` / `nq` n8
    tiles, each consumer warp owning `mt` m16 tiles of P; stages of `rows`
    mask rows, `stages` of them; a block taken by a cluster of `cluster`
    CTAs, each with `p_cta` columns of P, `warps` consumer warps, `chains`
    chain warps and a producer warp; `smem_bytes` of dynamic shared memory
    a CTA."""
    nc: int
    nq: int
    mt: int
    rows: int
    stages: int
    cluster: int
    warps: int
    chains: int
    p_cta: int
    smem_bytes: int


def col_tiles(n: int) -> int:
    """n8 tiles that hold n <= 64 columns: 2, 4 or 8 (16 columns at least,
    the k16 step of the weight products; csrc/fused_kernels.cu: col_tiles)."""
    return 2 if n <= 16 else 4 if n <= 32 else 8


def warp_tiles(nc: int, nq: int) -> int:
    """m16 tiles of P a consumer warp owns: its s accumulators (4 nq a
    tile) and patch fragments (2 nc) take at most 96 registers a thread."""
    return min(12, 96 // (4 * nq + 2 * nc))


def smem_bytes(nc, nq, rows, stages, cluster, warps, p_cta, w_bf16) -> int:
    """Dynamic shared memory of one CTA (fused_layout): the ring, the warps'
    f32 partials, the CTA's sums on their way out, the cluster's sums of
    the CTA's rows, hw on its way out and arrived, the chain's act tile and
    a_edge, W1 and W2, and the mbarriers, after the alignment slack."""
    lde, ldh = nc * 8 + 8, nq * 8 + 8
    kc = nc // 2 * 16
    ldw = ldh if w_bf16 else nq * 8
    ring = stages * (p_cta // BOX_COLS) * rows * 128
    partial = warps * rows * lde * 4
    e_in = 2 * 2 * rows * lde * 4                  # on the way out, and in
    hw_in = 2 * 2 * rows * ldh * 2
    chain = rows * (nc * 8 + 8) * 4 + 2 * rows * nc * 8 * 4   # act tile, a_edge
    wsm = -(-2 * kc * ldw * (2 if w_bf16 else 4) // 16) * 16
    return (SMEM_ALIGN + ring + partial + e_in + hw_in + chain + wsm
            + (2 * stages + 4) * 8)


def fused_tiling(p: int, c: int, q: int, smem_limit: int, w_bf16: bool = True,
                 cluster: int | None = None, rows: int | None = None) -> FusedTiling:
    """The tiling of the bf16 kernel at patch width P, C and q columns, for
    a card with `smem_limit` bytes of shared memory a CTA: the smallest
    cluster (1, 2, 4, or only `cluster`) whose CTAs hold their slice of s
    in at most MAX_WARPS warps, with at least three stages of 32 rows (16
    where three do not fit, or C > 32), else two; as many stages as fit,
    four at most (`cluster` and `rows` force one; the variant timings use
    them).  Raises ValueError for a shape it cannot cover (P not a multiple
    of 8, C or q past 64) or that no tiling fits."""
    if p < 1 or p % 8 or not 1 <= c <= 64 or not 1 <= q <= 64:
        raise ValueError(f"fused_boundary_dot kernel: P={p}, C={c}, q={q}: "
                         "P must be a multiple of 8, C and q at most 64")
    nc, nq = col_tiles(c), col_tiles(q)
    mt = warp_tiles(nc, nq)
    for min_stages in (3, 2):
        for k in ((cluster,) if cluster else CLUSTERS):
            per_cta = -(-p // k)
            p_cta = -(-per_cta // BOX_COLS) * BOX_COLS
            for r in ((rows,) if rows else (32, 16) if nc < 8 else (16,)):
                warps = -(-p_cta // (16 * mt))
                if warps > MAX_WARPS or r not in (16, 32) or (r == 32 and nc == 8):
                    continue
                for stages in range(4, min_stages - 1, -1):
                    n = smem_bytes(nc, nq, r, stages, k, warps, p_cta, w_bf16)
                    if n <= smem_limit:
                        chains = 2 if warps + 3 <= CTA_WARPS else 1
                        return FusedTiling(nc, nq, mt, r, stages, k, warps,
                                           chains, p_cta, n)
    raise ValueError(f"fused_boundary_dot kernel: no tiling of P={p}, C={c}, "
                     f"q={q} fits {smem_limit} bytes of shared memory"
                     + (f" in a cluster of {cluster}" if cluster else ""))


def f32_smem_bytes(p: int, c: int, q: int) -> int:
    """Shared memory of the f32-mask kernel: the block's s (P, q) f32, a
    16-row f32 mask tile and the tile's activations (f32_smem_bytes)."""
    a16 = lambda n: -(-n // 16) * 16
    return a16(4 * p * q) + a16(4 * 16 * p) + 4 * 16 * (c + q)


def launch(lib, tl: FusedTiling, masks, patches, a_edge, w1, w2, outs):
    """One launch of the bf16 kernel of `lib` with tiling `tl` into outs
    (act, h1, s); masks and patches bf16 and contiguous.  Raises where the
    entry refuses the launch."""
    b, nb, et, p = masks.shape
    c, q = patches.shape[3], w1.shape[-1]
    dev = masks.device.index
    a = a_edge.contiguous()
    f1 = w1.to(torch.float32).contiguous()
    f2 = w2.to(torch.float32).contiguous()
    bf = torch.bfloat16
    err = lib.fused_boundary(
        masks.data_ptr(), patches.data_ptr(), a.data_ptr(), f1.data_ptr(),
        f2.data_ptr(), *(o.data_ptr() for o in outs), b * nb, et, p, c, q,
        int(a.dtype == bf), int(w1.dtype == bf), int(outs[0].dtype == bf),
        tl.nc, tl.nq, tl.mt, tl.rows, tl.stages, tl.cluster, tl.warps,
        tl.chains, tl.p_cta, tl.smem_bytes, dev, build.stream(dev))
    build.check_launch(err, "fused_boundary")


def fused_boundary_dot(masks: torch.Tensor, patches: torch.Tensor,
                       a_edge: torch.Tensor, w1: torch.Tensor,
                       w2: torch.Tensor, act=torch.relu):
    """masks (B, NB, ET, P) bf16/f32 one-hot, patches (B, NB, P, C), a_edge
    (B, NB, ET, C), w1/w2 (C, q) -> (act_out (B, NB, ET, C) in the patches'
    dtype, h1 (B, NB, ET, q) f32, s (B, NB, P, q) f32)."""
    _check(masks, patches, a_edge, w1, w2)
    if masks.device.type == "cpu":
        return boundary_reference(masks, patches, a_edge, w1, w2, act)
    if act not in (torch.relu, torch.nn.functional.relu):
        raise NotImplementedError("the fused boundary kernel applies relu only")
    if w1.dtype != w2.dtype:
        raise ValueError("fused_boundary_dot kernel: w1 and w2 differ in dtype")
    b, nb, et, p = masks.shape
    c, q = patches.shape[3], w1.shape[-1]
    dev = masks.device
    limit = max_smem(dev)
    if masks.dtype == torch.bfloat16:
        tl = fused_tiling(p, c, q, limit, w1.dtype == torch.bfloat16)
    elif f32_smem_bytes(p, c, q) > limit:
        raise ValueError(f"fused_boundary_dot: f32 masks at P={p}, q={q} need "
                         f"{f32_smem_bytes(p, c, q)} bytes of shared memory, "
                         f"over the card's {limit}")
    masks = masks.contiguous()
    pt = patches.to(masks.dtype).contiguous()
    outs = (torch.empty((b, nb, et, c), dtype=patches.dtype, device=dev),
            torch.empty((b, nb, et, q), dtype=torch.float32, device=dev),
            torch.empty((b, nb, p, q), dtype=torch.float32, device=dev))
    if masks.dtype == torch.bfloat16:
        launch(library(), tl, masks, pt, a_edge, w1, w2, outs)
    else:
        a = a_edge.contiguous()
        f1 = w1.to(torch.float32).contiguous()
        f2 = w2.to(torch.float32).contiguous()
        bf = torch.bfloat16
        err = library().fused_boundary_f32(
            masks.data_ptr(), pt.data_ptr(), a.data_ptr(), f1.data_ptr(),
            f2.data_ptr(), *(o.data_ptr() for o in outs), b * nb, et, p, c, q,
            int(a.dtype == bf), int(w1.dtype == bf), int(patches.dtype == bf),
            f32_smem_bytes(p, c, q), dev.index, build.stream(dev.index))
        build.check_launch(err, "fused_boundary_f32")
    tracing.count("launch.fused_boundary_dot")
    return outs
