"""Kernels D and F's launch (csrc/block_kernels.cu, patch_gather_kernel),
checked on the CPU because the kernel runs only on a card.

The tiling that block_kernels.gather_tiling chooses takes 16-byte accesses
at every width the paths give the gathers (whole row pieces at C a
multiple of the vector, flat 16-byte vectors of the output at C 1-9), each
at a 16-byte offset; its CTAs cover every access of a block exactly once,
with at most GATHER_PER_THREAD accesses a thread and no shared memory.
The kernel's three access loops, emulated thread by thread with its
index arithmetic (a flat vector's elements straddle edges at C 1, 3, 6 and
9), reproduce the plain version bit for bit, out-of-range positions
included; shapes off the 16-byte paths take one element per access.
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops.kernels import block_kernels as BK

# the paths' patch sizes and edges per block: the 32^3 block route (core
# (4,4,8), K 14), the 64^3 index route (core (4,8,8), K 13 past the self
# slot) and its test core (8,8,8); blocks per launch of each
ROUTE_SHAPES = {768: 1792, 1152: 3328, 1728: 6656}
ROUTE_BLOCKS = {768: 1024, 1152: 1024, 1728: 512}


def _accesses(tl, n):
    """Access ids of every (CTA of a block, thread), in the kernel's order:
    CTA x's thread t takes x * 256 + t, stepping by chunks * 256."""
    step = tl.chunks * BK.GATHER_THREADS
    return {(x, t): list(range(x * BK.GATHER_THREADS + t, n, step))
            for x in range(tl.chunks) for t in range(BK.GATHER_THREADS)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 6, 9, 16, 32, 64])
@pytest.mark.parametrize("p", sorted(ROUTE_SHAPES))
def test_gather_tiling_takes_16_byte_accesses(p, c, dtype):
    et = ROUTE_SHAPES[p]
    elem = torch.empty((), dtype=dtype).element_size()
    tl = BK.gather_tiling(et, c, elem, True, True)
    v = 16 // elem
    assert tl.path == (BK.ROWS if c % v == 0 else BK.FLAT)
    # every access 16 bytes at a 16-byte offset: a block's output starts at
    # blk * ET * C elements; a row piece at q * C + a multiple of V
    assert (et * c) % v == 0
    if tl.path == BK.ROWS:
        assert (c * elem) % 16 == 0
    # the CTAs of a block cover its accesses once, GATHER_PER_THREAD each
    # at most, and the grid of every block's CTAs fits one launch
    n = et * c // v
    seen = np.zeros(n, dtype=np.int64)
    for ids in _accesses(tl, n).values():
        assert len(ids) <= BK.GATHER_PER_THREAD
        seen[ids] += 1
    assert (seen == 1).all()
    assert (tl.chunks - 1) * BK.GATHER_THREADS * BK.GATHER_PER_THREAD < n
    assert ROUTE_BLOCKS[p] * tl.chunks < 2 ** 31


@pytest.mark.parametrize("et,c,elem,pat16,out16,path", [
    (1792, 64, 2, False, True, BK.FLAT),     # unaligned patches: elements
    (203, 3, 2, True, True, BK.SCALAR),      # ET * C not whole vectors
    (1792, 64, 4, True, False, BK.SCALAR),   # unaligned output
])
def test_gather_tiling_off_the_16_byte_paths(et, c, elem, pat16, out16, path):
    tl = BK.gather_tiling(et, c, elem, pat16, out16)
    assert tl.path == path
    n = et * c // (1 if path == BK.SCALAR else 16 // elem)
    assert tl.chunks * BK.GATHER_THREADS * BK.GATHER_PER_THREAD >= n


def _bits(t):
    """A tensor's elements as integers of their width (copies are exact)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _emulate(pos, patches, tl):
    """patch_gather_kernel's loops over every (block, CTA, thread), on the
    integer bits of the elements."""
    b, nb, p, c = patches.shape
    et = pos.shape[2]
    src_all = _bits(patches.reshape(b * nb, p * c))
    pos_all = pos.reshape(b * nb, et).numpy()
    out = np.full((b * nb, et * c), -1, dtype=src_all.dtype)
    v = 1 if tl.path == BK.SCALAR else 16 // patches.element_size()
    n = et * c // v
    for blk in range(b * nb):
        src, pp, o = src_all[blk], pos_all[blk], out[blk]
        for ids in _accesses(tl, n).values():
            for i in ids:
                if tl.path == BK.ROWS:
                    e = i * v // c
                    q = pp[e]
                    piece = src[q * c + i * v - e * c:][:v] if 0 <= q < p else 0
                    o[i * v:(i + 1) * v] = piece
                elif tl.path == BK.FLAT:
                    e = i * v // c
                    ch = i * v - e * c
                    q = pp[e]
                    for j in range(v):
                        o[i * v + j] = src[q * c + ch] if 0 <= q < p else 0
                        ch += 1
                        if ch == c:
                            ch = 0
                            e += 1
                            if e < et:
                                q = pp[e]
                else:
                    e, ch = i // c, i % c
                    q = pp[e]
                    o[i] = src[q * c + ch] if 0 <= q < p else 0
    return torch.from_numpy(out).view(patches.dtype).reshape(b, nb, et, c)


def _inputs(b, nb, et, p, c, dtype, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(-3, p + 3, (b, nb, et)).astype(np.int32)
    pat = rng.normal(size=(b, nb, p, c)).astype(np.float32)
    return torch.from_numpy(pos), torch.from_numpy(pat).to(dtype)


def _check(pos, pat, tl, fast):
    """The emulated kernel against block_gather_plain (kernel F's plain
    version; D's is the same gather on bf16).  The kernel rounds each f32
    value to bf16 as it loads it (fast mode), which commutes with the copy."""
    want = BK.block_gather_plain(pos, pat, fast)
    src = BK._round_if(pat, fast)
    assert torch.equal(_emulate(pos, src, tl), want)


@pytest.mark.parametrize("dtype,fast", [(torch.bfloat16, False),
                                        (torch.float32, True)])
@pytest.mark.parametrize("c", [1, 3, 6, 9])
def test_flat_vectors_reproduce_the_plain_gather(c, dtype, fast):
    """At C 1-9 a 16-byte vector holds elements of up to 8 edges; the
    route's 32^3 block shape (P 768, ET 1792), two blocks."""
    pos, pat = _inputs(1, 2, 1792, 768, c, dtype, seed=c)
    tl = BK.gather_tiling(1792, c, pat.element_size(), True, True)
    assert tl.path == BK.FLAT
    _check(pos, pat, tl, fast)


@pytest.mark.parametrize("p,et,c,dtype,fast", [
    (1152, 3328, 64, torch.bfloat16, False),   # kernel D at C 64
    (1728, 6656, 32, torch.bfloat16, False),   # the (8,8,8) core
    (768, 1792, 64, torch.float32, True),      # kernel F, f32 fast
    (768, 1792, 16, torch.bfloat16, True),     # two vectors a row
])
def test_row_pieces_reproduce_the_plain_gather(p, et, c, dtype, fast):
    pos, pat = _inputs(1, 1, et, p, c, dtype, seed=p + c)
    tl = BK.gather_tiling(et, c, pat.element_size(), True, True)
    assert tl.path == BK.ROWS
    _check(pos, pat, tl, fast)


@pytest.mark.parametrize("c,dtype", [(3, torch.bfloat16), (5, torch.float32)])
def test_single_elements_reproduce_the_plain_gather(c, dtype):
    """A ragged shape (P 61, ET 203) off the 16-byte paths."""
    pos, pat = _inputs(2, 3, 203, 61, c, dtype, seed=c)
    tl = BK.gather_tiling(203, c, pat.element_size(), True, True)
    assert tl.path == BK.SCALAR
    _check(pos, pat, tl, False)
