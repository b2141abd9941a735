"""The 15-op cube-form layer's edge epilogue and its edge transpose
(wrappers of csrc/edge_epilogue.cu), with their autograd Functions and
plain PyTorch twins.

``edge_epilogue`` is everything models/shiftinv15.shift_inv_15op_layer
does to its (b, 2, N, K, q) edge tensors between its products and its
neighbor gathers and the next layer:

    out = p0 + T + [g_col | x_col] + [x_row | g_row]     (block A | block B)
    out[:, 0, :, 0] += d2 + d5 + d8 + a9 + a10 + p11 + p12 + b0 + b1
    out[elsewhere]  += a9 + p11 + b1
    out = relu?(out * [1 | mask_b])

with T the product mm(T(h), w1) (the layer widens, q >= C) or the edge
transpose of t = mm(h, w1) (q < C): block A rev * (1 - mb) + t[:, 1] * mb,
block B t[:, 0] * mb, rev the reverse-edge lookup rows of t[:, 0].
``edge_transpose`` is that transpose alone, T(h) (f32), the operand of
the product where q >= C.  The adds keep the order and dtype promotion of
the unfused chain (``epilogue_plain``, which is it), so the forward
kernels give its values bit for bit; only the sign of a zero in a masked
row may differ (csrc/edge_epilogue.cu).  The backward kernels sum in f32
and write each gradient in its operand's dtype, in a fixed order.

Each wrapper takes its plain PyTorch twin only for CPU tensors; on a card
it launches its kernel, on PyTorch's current stream, with outputs and
scratch from torch.empty.  ``edge_epilogue`` and ``edge_transpose`` run
the autograd Functions, and raise ValueError for CUDA operands the
kernels do not take (not one f32 / bf16 dtype, biases not f32 / bf16
each, a mask not f32, or a width over what a block's thread group holds).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "edge_epilogue_forward": (_P, _P, _P) + (_L,) * 4 + (_I,) * 7 + (_P,),
    "edge_epilogue_backward": (_P,) * 6 + (_L,) * 4 + (_I,) * 6 + (_P,),
    "edge_transpose_forward": (_P,) * 4 + (_L,) * 4 + (_I,) * 3 + (_P,),
    "edge_transpose_backward": (_P,) * 4 + (_L,) * 4 + (_I,) * 3 + (_P,),
}
# threads a block; a node's group of width / vec threads must fit in one
_THREADS = 256
# blocks the backward aims at over the batch (its partial sums a sample)
_BACKWARD_BLOCKS = 1024


def library():
    """The built and loaded csrc/edge_epilogue.cu (compiled at first use)."""
    return build.load("edge_epilogue", _SIGNATURES)


# ---------------------------------------------------------------- twins

def transpose_plain(h: torch.Tensor, rev: torch.Tensor,
                    mask_b: torch.Tensor) -> torch.Tensor:
    """The edge transpose (shiftinv15.py:224-272) given the lookup rows rev
    = h[:, 0] at each edge's reverse: an A slot takes its reverse A edge
    where it exists, else its masked B mirror; a B slot its A mirror."""
    mb = mask_b[..., None]
    ta = rev * (1.0 - mb) + h[:, 1] * mb
    return torch.stack([ta, h[:, 0] * mb], dim=1)


def epilogue_plain(relu: bool, mask_b, p0, t, rev, g_col, g_row, x_col,
                   x_row, d2, d5, d8, a9, a10, p11, p12, b0, b1) -> torch.Tensor:
    """The unfused epilogue (the module docstring's chain), every add in
    the order and dtype of the layer before the fusion: the diagonal's
    contributions land on the self slots in the order of JAX's _at_dia
    adds."""
    out = p0 + (t if rev is None else transpose_plain(t, rev, mask_b))
    out = out + torch.stack([g_col, x_col[:, :, None, :].expand_as(g_col)], 1)
    out = out + torch.stack([x_row[:, :, None, :].expand_as(g_row), g_row], 1)
    diag = out[:, 0, :, 0, :]
    for term in (d2, d5, d8, a9[:, None], a10[:, None], p11[:, None],
                 p12[:, None], b0, b1):
        diag = diag + term
    out = out + a9[:, None, None, None] + p11[:, None, None, None] + b1
    sel = torch.zeros(out.shape[1:-1] + (1,), dtype=torch.bool, device=out.device)
    sel[0, :, 0] = True                                 # block A's self slots
    out = torch.where(sel, diag[:, None, :, None, :], out)
    out = out * torch.stack([torch.ones_like(mask_b), mask_b], dim=1)[..., None]
    return torch.relu(out) if relu else out


def epilogue_backward_plain(grad: torch.Tensor, y: Optional[torch.Tensor],
                            mask_b: torch.Tensor, select: bool,
                            dtype: torch.dtype, bias_dtype: torch.dtype
                            ) -> Tuple[Optional[torch.Tensor], ...]:
    """The epilogue's gradients, in its operands' order (p0 ... b1), from
    the output's gradient `grad` and, under relu, the output y: gp = grad
    (0 where y <= 0) times the block mask; sums in grad's dtype, each
    result in its operand's dtype."""
    if y is not None:
        grad = torch.where(y <= 0, torch.zeros_like(grad), grad)
    mb = mask_b[..., None].to(grad.dtype)
    gp = grad * torch.stack([torch.ones_like(mb), mb], dim=1)
    ga, gb = gp[:, 0], gp[:, 1]
    d_p0 = gp.to(dtype)
    if select:
        d_t = torch.stack([gb * mb, ga * mb], dim=1).to(dtype)
        d_rev = (ga * (1.0 - mb)).to(dtype)
    else:
        d_t, d_rev = d_p0, None
    gd = ga[:, :, 0]
    d_diag = gd.to(dtype)
    s_all, s_diag = gp.sum(dim=(1, 2, 3)), gd.sum(dim=1)
    d_a9, d_a10 = s_all.to(dtype), s_diag.to(dtype)
    return (d_p0, d_t, d_rev, ga.to(dtype), gb.to(dtype), gb.sum(2).to(dtype),
            ga.sum(2).to(dtype), d_diag, d_diag, d_diag, d_a9, d_a10, d_a9,
            d_a10, s_diag.sum(0).to(bias_dtype), s_all.sum(0).to(bias_dtype))


def transpose_backward_plain(grad: torch.Tensor, mask_b: torch.Tensor,
                             dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transpose's gradients (dh, drev) in `dtype`: dh[:, 0] = gradB *
    mb, dh[:, 1] = gradA * mb, drev = gradA * (1 - mb)."""
    mb = mask_b[..., None].to(grad.dtype)
    ga, gb = grad[:, 0], grad[:, 1]
    return (torch.stack([gb * mb, ga * mb], dim=1).to(dtype),
            (ga * (1.0 - mb)).to(dtype))


# ---------------------------------------------------------------- kernels

def _vec(width: int, *tensors: torch.Tensor) -> int:
    """Elements per access: the widest of 4, 2, 1 dividing the width and
    every buffer's alignment."""
    for v in (4, 2):
        if width % v == 0 and all(t.data_ptr() % (v * t.element_size()) == 0
                                  for t in tensors):
            return v
    return 1


def _check(name: str, width: int, mask_b: torch.Tensor,
           tensors: Sequence[torch.Tensor],
           extra: Sequence[torch.Tensor] = ()):
    """Raise ValueError unless the kernels take these operands: `tensors`
    of one f32 or bf16 dtype (`extra`, the biases, f32 or bf16 each), an
    f32 mask, all on one device, and a width whose thread group (width /
    vec threads a node) fits in a block at any vec."""
    dev, dt = mask_b.device, tensors[0].dtype
    if any(t.device != dev for t in (*tensors, *extra)):
        raise ValueError(f"{name}: operands on more than one device")
    if mask_b.dtype != torch.float32:
        raise ValueError(f"{name} kernel takes a float32 mask, got {mask_b.dtype}")
    if dt not in KERNEL_DTYPES or any(t.dtype != dt for t in tensors):
        raise ValueError(f"{name} kernel takes operands of one dtype, float32 "
                         f"or bfloat16, got {sorted({str(t.dtype) for t in tensors})}")
    if any(t.dtype not in KERNEL_DTYPES for t in extra):
        raise ValueError(f"{name} kernel takes float32 or bfloat16 biases, got "
                         f"{[str(t.dtype) for t in extra]}")
    if width > _THREADS:
        raise ValueError(f"{name} kernel takes widths up to {_THREADS}, got {width}")


def _launch_forward(relu: bool, mask_b, terms) -> torch.Tensor:
    p0, t, rev = terms[:3]
    b0, b1 = terms[-2:]
    b, _, n, k, q = p0.shape
    select = rev is not None
    bf16 = p0.dtype == torch.bfloat16
    out = torch.empty(p0.shape, dtype=torch.float32, device=p0.device)
    vec = _vec(q, out, *(x for x in terms if x is not None))
    ptrs = (ctypes.c_void_p * len(terms))(
        *(None if x is None else x.data_ptr() for x in terms))
    dev = p0.device.index
    err = library().edge_epilogue_forward(
        ctypes.addressof(ptrs), mask_b.data_ptr(), out.data_ptr(), b, n, k, q,
        vec, int(bf16), int(select), int(bf16 and not select),
        int(b0.dtype == torch.bfloat16), int(relu), dev, build.stream(dev))
    build.check_launch(err, "edge_epilogue_forward")
    tracing.count("launch.edge_epilogue_forward")
    return out


def _launch_backward(grad, y, mask_b, select: bool, dtype, bias_dtype):
    b, _, n, k, q = grad.shape
    dev = grad.device

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)

    d_p0 = empty(b, 2, n, k, q)
    d_t, d_rev = (empty(b, 2, n, k, q), empty(b, n, k, q)) if select else (None, None)
    d_gcol, d_grow = empty(b, n, k, q), empty(b, n, k, q)
    d_xcol, d_xrow, d_diag = empty(b, n, q), empty(b, n, q), empty(b, n, q)
    outs = (d_p0, d_t, d_rev, d_gcol, d_grow, d_xcol, d_xrow, d_diag)
    vec = _vec(q, grad, *(x for x in (y, *outs) if x is not None))
    per = _THREADS // (q // vec)
    nbx = max(1, min(-(-n // per), -(-_BACKWARD_BLOCKS // b)))
    partials = empty(b, nbx, 2, q, dt=torch.float32)
    sums = empty(2, b + 1, q, dt=torch.float32)
    ptrs = (ctypes.c_void_p * len(outs))(
        *(None if x is None else x.data_ptr() for x in outs))
    di = dev.index
    err = library().edge_epilogue_backward(
        grad.data_ptr(), None if y is None else y.data_ptr(), mask_b.data_ptr(),
        ctypes.addressof(ptrs), partials.data_ptr(), sums.data_ptr(), b, n, k,
        q, vec, int(dtype == torch.bfloat16), int(select), int(y is not None),
        nbx, di, build.stream(di))
    build.check_launch(err, "edge_epilogue_backward")
    tracing.count("launch.edge_epilogue_backward")
    d_a9, d_a10 = sums[0, :b].to(dtype), sums[1, :b].to(dtype)
    return (d_p0, d_t if select else d_p0, d_rev, d_gcol, d_grow, d_xcol, d_xrow,
            d_diag, d_diag, d_diag, d_a9, d_a10, d_a9, d_a10,
            sums[1, b].to(bias_dtype), sums[0, b].to(bias_dtype))


def _launch_transpose(h, rev, mask_b) -> torch.Tensor:
    b, _, n, k, w = h.shape
    out = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    dev = h.device.index
    err = library().edge_transpose_forward(
        h.data_ptr(), rev.data_ptr(), mask_b.data_ptr(), out.data_ptr(), b, n,
        k, w, _vec(w, h, rev, out), int(h.dtype == torch.bfloat16), dev,
        build.stream(dev))
    build.check_launch(err, "edge_transpose_forward")
    tracing.count("launch.edge_transpose_forward")
    return out


def _launch_transpose_backward(grad, mask_b, dtype):
    b, _, n, k, w = grad.shape
    dh = torch.empty(grad.shape, dtype=dtype, device=grad.device)
    drev = torch.empty((b, n, k, w), dtype=dtype, device=grad.device)
    dev = grad.device.index
    err = library().edge_transpose_backward(
        grad.data_ptr(), mask_b.data_ptr(), dh.data_ptr(), drev.data_ptr(), b,
        n, k, w, _vec(w, grad, dh, drev), int(dtype == torch.bfloat16), dev,
        build.stream(dev))
    build.check_launch(err, "edge_transpose_backward")
    tracing.count("launch.edge_transpose_backward")
    return dh, drev


# ------------------------------------------------- wrappers and Functions

def edge_epilogue_forward(relu: bool, mask_b: torch.Tensor, *terms) -> torch.Tensor:
    """The epilogue's output: epilogue_plain on CPU tensors, else its
    kernel."""
    if mask_b.device.type == "cpu":
        return epilogue_plain(relu, mask_b, *terms)
    return _launch_forward(relu, mask_b, [None if x is None else x.contiguous()
                                          for x in terms])


def edge_epilogue_backward(grad, y, mask_b, select, dtype, bias_dtype):
    """The epilogue's gradients: epilogue_backward_plain on CPU tensors,
    else its kernel and the sums' second pass."""
    if grad.device.type == "cpu":
        return epilogue_backward_plain(grad, y, mask_b, select, dtype, bias_dtype)
    return _launch_backward(grad.contiguous(), y, mask_b, select, dtype, bias_dtype)


def edge_transpose_forward(h, rev, mask_b) -> torch.Tensor:
    """T(h): transpose_plain on CPU tensors, else its kernel."""
    if h.device.type == "cpu":
        return transpose_plain(h, rev, mask_b)
    return _launch_transpose(h.contiguous(), rev.contiguous(), mask_b)


def edge_transpose_backward(grad, mask_b, dtype):
    """(dh, drev): transpose_backward_plain on CPU tensors, else its
    kernel."""
    if grad.device.type == "cpu":
        return transpose_backward_plain(grad, mask_b, dtype)
    return _launch_transpose_backward(grad.contiguous(), mask_b, dtype)


class EdgeEpilogue(torch.autograd.Function):
    """The epilogue's wrappers as one autograd Function; saves the mask
    and, under relu, the output (the sign of the relu)."""

    @staticmethod
    def forward(ctx, relu, mask_b, *terms):
        out = edge_epilogue_forward(relu, mask_b, *terms)
        ctx.select = terms[2] is not None
        ctx.dtypes = (terms[0].dtype, terms[-1].dtype)
        ctx.save_for_backward(mask_b, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, grad):
        mask_b, y = ctx.saved_tensors
        return (None, None) + edge_epilogue_backward(grad, y, mask_b, ctx.select,
                                                     *ctx.dtypes)


class EdgeTranspose(torch.autograd.Function):
    """The transpose's wrappers as one autograd Function."""

    @staticmethod
    def forward(ctx, h, rev, mask_b):
        ctx.save_for_backward(mask_b)
        ctx.dtype = h.dtype
        return edge_transpose_forward(h, rev, mask_b)

    @staticmethod
    def backward(ctx, grad):
        mask_b, = ctx.saved_tensors
        return edge_transpose_backward(grad, mask_b, ctx.dtype) + (None,)


def edge_transpose(h: torch.Tensor, rev: torch.Tensor,
                   mask_b: torch.Tensor) -> torch.Tensor:
    """h (b, 2, N, K, C), its lookup rows rev (b, N, K, C) and mask_b (b, N,
    K) f32 -> the edge transpose T(h) (b, 2, N, K, C) in the promoted
    dtype (f32 for f32 / bf16 h)."""
    if mask_b.device.type == "cuda":
        _check("edge_transpose", h.shape[-1], mask_b, (h, rev))
    return EdgeTranspose.apply(h, rev, mask_b.contiguous())


def edge_epilogue(p0, t, rev, g_col, g_row, x_col, x_row, d2, d5, d8, a9,
                  a10, p11, p12, b0, b1, mask_b: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    """The layer's output edges (b, 2, N, K, q), f32 for f32 / bf16
    operands: p0 = mm(h, w0) and t = mm(T(h), w1) (rev None), or t = mm(h,
    w1) and rev its lookup rows (b, N, K, q) to transpose after the
    product; the broadcast gathers g_col, g_row (b, N, K, q) of x_col,
    x_row (b, N, q); the diagonal's node terms d2, d5, d8 (b, N, q) and
    sample terms a10, p12 (b, q); the per-sample terms a9, p11 (b, q); the
    biases b0, b1 (q,); relu applied where `relu`."""
    terms = (p0, t, rev, g_col, g_row, x_col, x_row, d2, d5, d8, a9, a10,
             p11, p12, b0, b1)
    if mask_b.device.type == "cuda":
        _check("edge_epilogue", p0.shape[-1], mask_b,
               [x for x in terms[:-2] if x is not None], (b0, b1))
    return EdgeEpilogue.apply(relu, mask_b.contiguous(), *terms)
