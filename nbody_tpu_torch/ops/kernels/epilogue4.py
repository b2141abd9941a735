"""The 4-op layer's epilogue (wrapper of csrc/epilogue4.cu), with its
autograd Function and plain PyTorch twins.

``epilogue4`` is what models/shiftinv.py's layer, in both network forms,
does to its edge tensors after the products and the neighbor gather:

    out = relu?(h1 + h2 + h3 + h4 + bias)

h1, h2 (b, ..., K, q) edge terms (h1 may be the slice h12[..., :q] of the
layer's joint product: its row stride is read in place), h3 (b, ..., q)
a node term broadcast over K, h4 (b, q) a sample term, bias (q,); the
dots are N on the cube form and (NB, R) on the block-major form.  The
adds keep the chain's order and dtype (``epilogue4_plain``, which is it),
so the forward kernel gives its values bit for bit; only a zero's sign
may differ.  The backward kernel writes relu's masked gradient once (the
gradient of h1 and of h2; without relu that is the incoming gradient
itself), sums it over K in f32 for h3, and finishes the sums for h4 and
the bias in a fixed second pass; each result is in its operand's dtype.

Each wrapper takes its plain PyTorch twin only for CPU tensors; on a card
it launches its kernel, on PyTorch's current stream, with outputs and
scratch from torch.empty.  ``epilogue4`` runs the autograd Function, and
raises ValueError for CUDA operands the kernel does not take (not one f32
or bf16 dtype, shapes that do not broadcast as above, or a width over
what a block's thread group holds).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from nbody_tpu_torch import tracing
from nbody_tpu_torch.ops.kernels import build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "epilogue4_forward": (_P, _L) + (_P,) * 5 + (_L,) * 4 + (_I,) * 5 + (_P,),
    "epilogue4_backward": (_P,) * 7 + (_L,) * 4 + (_I,) * 5 + (_P,),
}
# threads a block; a node's group of q / vec threads must fit in one
_THREADS = 256
# blocks the backward aims at over the batch (its partial sums a sample)
_BACKWARD_BLOCKS = 1024
# rows of at most this many bytes take the narrow forward, a thread a row
_NARROW_BYTES = 32


def library():
    """The built and loaded csrc/epilogue4.cu (compiled at first use)."""
    return build.load("epilogue4", _SIGNATURES)


# ---------------------------------------------------------------- twins

def _sample_view(h4: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """h4 (b, q) as (b, 1, ..., 1, q), broadcasting against `like`."""
    return h4.reshape((h4.shape[0],) + (1,) * (like.dim() - 2) + h4.shape[-1:])


def epilogue4_plain(h1, h2, h3, h4, bias, relu: bool) -> torch.Tensor:
    """The unfused chain, every add in the layer's order and dtype."""
    out = h1 + h2 + h3.unsqueeze(-2) + _sample_view(h4, h1) + bias
    return torch.relu(out) if relu else out


def epilogue4_backward_plain(grad: torch.Tensor, y: Optional[torch.Tensor],
                             dtypes) -> Tuple[torch.Tensor, ...]:
    """The chain's gradients (h1, h2, h3, h4, bias) from the output's
    gradient and, under relu, the output y: g = grad, 0 where y <= 0; its
    sums over K (h3), over every axis but the batch and the channel (h4)
    and over all but the channel (bias), in f32 (f64 for f64), each in its
    operand's dtype (`dtypes`)."""
    if y is not None:
        grad = torch.where(y <= 0, torch.zeros_like(grad), grad)
    s3 = grad.to(torch.promote_types(grad.dtype, torch.float32)).sum(dim=-2)
    s4 = s3.reshape(s3.shape[0], -1, s3.shape[-1]).sum(dim=1)
    return (grad, grad, s3.to(dtypes[2]), s4.to(dtypes[3]),
            s4.sum(dim=0).to(dtypes[4]))


# ---------------------------------------------------------------- kernels

def _vec(q: int, stride: int, *tensors: torch.Tensor) -> int:
    """Elements per access: the widest of 16 bytes, 4, 2, 1 elements
    dividing the width, h1's row stride and every buffer's alignment."""
    es = tensors[0].element_size()
    for v in (16 // es, 4, 2):
        if q % v == 0 and stride % v == 0 and all(
                t.data_ptr() % (v * es) == 0 for t in tensors):
            return v
    return 1


def _row_stride(h: torch.Tensor) -> Optional[int]:
    """s where element (..., r, c) of h (2 axes or more), r its flat row
    over every axis but the last, lies at r * s + c (a contiguous tensor,
    or a slice of the last axis of one); else None."""
    if h.stride(-1) != 1 and h.shape[-1] > 1:
        return None
    s = span = h.stride(-2)
    for size, stride in zip(reversed(h.shape[:-1]), reversed(h.stride()[:-1])):
        if size > 1 and stride != span:
            return None
        span *= size
    return s


def _narrow(q: int, element_size: int) -> bool:
    """Whether rows of width q take the narrow forward kernel (a thread a
    row), else a thread group a node."""
    return q * element_size <= _NARROW_BYTES


def _check(h1, h2, h3, h4, bias):
    """Raise ValueError unless the kernel takes these operands: one f32 or
    bf16 dtype on one device; h2 of h1's shape (b, ..., K, q), h3 (b, ...,
    q), h4 (b, q), bias (q,); a width whose thread group (q / vec threads
    a node) fits in a block at any vec."""
    ops = (h1, h2, h3, h4, bias)
    dt, q = h1.dtype, h1.shape[-1]
    if any(t.device != h1.device for t in ops):
        raise ValueError("epilogue4: operands on more than one device")
    if dt not in KERNEL_DTYPES or any(t.dtype != dt for t in ops):
        raise ValueError(f"epilogue4 kernel takes operands of one dtype, float32 "
                         f"or bfloat16, got {sorted({str(t.dtype) for t in ops})}")
    if (h1.dim() < 3 or h2.shape != h1.shape
            or h3.shape != h1.shape[:-2] + (q,)
            or h4.shape != (h1.shape[0], q) or bias.shape != (q,)):
        raise ValueError(f"epilogue4 kernel takes h1, h2 (b, ..., K, q), h3 (b, "
                         f"..., q), h4 (b, q), bias (q,), got "
                         f"{[tuple(t.shape) for t in ops]}")
    if q > _THREADS:
        raise ValueError(f"epilogue4 kernel takes widths up to {_THREADS}, got {q}")


def _launch_forward(h1, h2, h3, h4, bias, relu: bool) -> torch.Tensor:
    b, k, q = h1.shape[0], h1.shape[-2], h1.shape[-1]
    s1 = q if h1.is_contiguous() else _row_stride(h1)
    if s1 is None:
        h1, s1 = h1.contiguous(), q
    out = torch.empty(h1.shape, dtype=h1.dtype, device=h1.device)
    vec = _vec(q, s1, h1, h2, h3, h4, bias, out)
    dev = h1.device.index
    err = library().epilogue4_forward(
        h1.data_ptr(), s1, h2.data_ptr(), h3.data_ptr(), h4.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h3.numel() // (b * q), k, q, vec,
        int(h1.dtype == torch.bfloat16), int(_narrow(q, h1.element_size())),
        int(relu), dev, build.stream(dev))
    build.check_launch(err, "epilogue4_forward")
    tracing.count("launch.epilogue4_forward")
    return out


def _launch_backward(grad, y):
    b, k, q = grad.shape[0], grad.shape[-2], grad.shape[-1]
    rows = grad.numel() // (b * k * q)
    dev, dt = grad.device, grad.dtype
    dg = torch.empty_like(grad) if y is not None else None
    d3 = torch.empty(grad.shape[:-2] + (q,), dtype=dt, device=dev)
    d4 = torch.empty((b, q), dtype=dt, device=dev)
    dbias = torch.empty((q,), dtype=dt, device=dev)
    vec = _vec(q, q, *(x for x in (grad, y, dg, d3) if x is not None))
    nbx = max(1, min(-(-rows // (_THREADS // (q // vec))),
                     -(-_BACKWARD_BLOCKS // b)))
    partials = torch.empty((b, nbx, q), dtype=torch.float32, device=dev)
    di = dev.index
    err = library().epilogue4_backward(
        grad.data_ptr(), None if y is None else y.data_ptr(),
        None if dg is None else dg.data_ptr(), d3.data_ptr(), d4.data_ptr(),
        dbias.data_ptr(), partials.data_ptr(), b, rows, k, q, vec,
        int(dt == torch.bfloat16), int(y is not None), nbx, di, build.stream(di))
    build.check_launch(err, "epilogue4_backward")
    tracing.count("launch.epilogue4_backward")
    g = grad if dg is None else dg
    return g, g, d3, d4, dbias


# ------------------------------------------------- wrappers and Function

def epilogue4_forward(h1, h2, h3, h4, bias, relu: bool) -> torch.Tensor:
    """The epilogue's output: epilogue4_plain on CPU tensors, else its
    kernel."""
    if h1.device.type == "cpu":
        return epilogue4_plain(h1, h2, h3, h4, bias, relu)
    return _launch_forward(h1, h2.contiguous(), h3.contiguous(),
                           h4.contiguous(), bias.contiguous(), relu)


def epilogue4_backward(grad, y, dtypes):
    """The epilogue's gradients: epilogue4_backward_plain on CPU tensors,
    else its kernel and the sums' second pass (in the one dtype that
    _check lets through)."""
    if grad.device.type == "cpu":
        return epilogue4_backward_plain(grad, y, dtypes)
    return _launch_backward(grad.contiguous(), y)


class Epilogue4(torch.autograd.Function):
    """The epilogue's wrappers as one autograd Function; saves, under
    relu, the output (the sign of the relu)."""

    @staticmethod
    def forward(ctx, h1, h2, h3, h4, bias, relu):
        out = epilogue4_forward(h1, h2, h3, h4, bias, relu)
        ctx.dtypes = tuple(x.dtype for x in (h1, h2, h3, h4, bias))
        ctx.save_for_backward(out if relu else None)
        return out

    @staticmethod
    def backward(ctx, grad):
        y, = ctx.saved_tensors
        return epilogue4_backward(grad, y, ctx.dtypes) + (None,)


def epilogue4(h1: torch.Tensor, h2: torch.Tensor, h3: torch.Tensor,
              h4: torch.Tensor, bias: torch.Tensor,
              relu: bool = False) -> torch.Tensor:
    """relu?(h1 + h2 + h3 + h4 + bias) over the layer's edges: h1, h2 (b,
    ..., K, q), h3 (b, ..., q) broadcast over K, h4 (b, q) over the edges
    of a sample, bias (q,); the result (b, ..., K, q) in their dtype.
    Where no gradient is recorded (the rollout's forward-only hop) the
    forward runs without the autograd Function's host cost."""
    ops = (h1, h2, h3, h4, bias)
    if h1.device.type == "cuda":
        _check(*ops)
    if torch.is_grad_enabled() and any(x.requires_grad for x in ops):
        return Epilogue4.apply(*ops, relu)
    return epilogue4_forward(*ops, relu)
