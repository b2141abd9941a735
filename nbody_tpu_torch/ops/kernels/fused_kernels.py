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
card.  It has two forms (kernel_form): bf16 masks of the shapes the
tensor cores take run the mask products as wmma tiles, everything else
runs them on the CUDA cores in f32.  The kernel is in
csrc/mask_kernels.cu (design note there); the wrapper takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from nbody_tpu_torch.ops.kernels import build
from nbody_tpu_torch.ops.kernels import mask_kernels as MK

# launches of the CUDA kernel in this process (reset by callers that count)
LAUNCHES = {"fused_boundary_dot": 0}
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


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


def kernel_form(p: int, c: int, q: int, mask_dtype: torch.dtype,
                device: torch.device):
    """(shared memory one CTA of kernel J takes, whether it is the
    tensor-core form) for this shape on `device`: the block's f32 s (P, q),
    a mask row tile and the row tile's activations.  bf16 masks with P, C
    and q multiples of 16 and C <= 64 take the tensor-core form when it
    fits; the rest the CUDA-core form."""
    tc = ctypes.c_int(0)
    n = MK.library().fused_boundary_smem_bytes(
        p, c, q, torch.finfo(mask_dtype).bits // 8, device.index,
        ctypes.byref(tc))
    return n, bool(tc.value)


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
    need, _ = kernel_form(p, c, q, masks.dtype, dev)
    limit = MK.library().mask_max_smem(dev.index)
    if need > limit:
        raise ValueError(f"fused_boundary_dot: P={p}, C={c}, q={q} need {need} "
                         f"bytes of shared memory, over the card's {limit}")
    masks = masks.contiguous()
    pt = patches.to(masks.dtype).contiguous()
    a = a_edge.contiguous()
    f1 = w1.to(torch.float32).contiguous()
    f2 = w2.to(torch.float32).contiguous()
    act_out = torch.empty((b, nb, et, c), dtype=patches.dtype, device=dev)
    h1 = torch.empty((b, nb, et, q), dtype=torch.float32, device=dev)
    s = torch.empty((b, nb, p, q), dtype=torch.float32, device=dev)
    bf = torch.bfloat16
    err = MK.library().fused_boundary(
        masks.data_ptr(), pt.data_ptr(), a.data_ptr(), f1.data_ptr(),
        f2.data_ptr(), act_out.data_ptr(), h1.data_ptr(), s.data_ptr(),
        b * nb, et, p, c, q, int(masks.dtype == bf), int(a.dtype == bf),
        int(w1.dtype == bf), int(patches.dtype == bf), dev.index,
        build.stream(dev.index))
    build.check_launch(err, "fused_boundary")
    LAUNCHES["fused_boundary_dot"] += 1
    return act_out, h1, s
