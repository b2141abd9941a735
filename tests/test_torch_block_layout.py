"""The masked route's block layout (ops/kernels/block_layout.py, the
wrappers of csrc/block_layout.cu): the fold's order of adds, the
wrappers' CPU path, their checks, launch counts and kernel names.

The CUDA kernels run only on a card (chip_smoke.py holds them bit-equal to
the plain versions there).  Here ``_fold_by_rows`` writes the fold kernel's
algorithm as a loop over cube rows -- each row's sum built from the
(block, site) entries that cover it, in the plain version's association
tree -- and holds it bit-equal to ``patches_fold_plain`` in f32 and bf16,
so the tree the kernel computes is the plain version's.  No JAX: the plain
versions are held against the JAX package in tests/test_torch_blocked.py.
"""

from __future__ import annotations

import collections
import re
from pathlib import Path

import pytest
import torch

from benchmark_torch.yardstick.buckets import bucket_of
from nbody_tpu_torch import config as C
from nbody_tpu_torch import tracing
from nbody_tpu_torch.data.dataset import features_from_raw, split_batch
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.models.registry import build_model
from nbody_tpu_torch.ops import blocked
from nbody_tpu_torch.ops.kernels import block_layout as BL

torch.set_num_threads(1)

CORES = [(4, 8, 8), (8, 8, 8), (4, 4, 8)]
SOURCE = Path(BL.__file__).resolve().parents[2] / "csrc" / "block_layout.cu"


def _axis_entries(cells, w, b, e, nb):
    """For every cube coordinate g of one axis: its padded coordinates
    (the core's g + w, then the ring's where g lies within w of a face),
    each with the (block j, site l) that hold it in ascending l."""
    out = []
    for g in range(cells):
        ps = [g + w]
        if g >= cells - w:
            ps.append(g - cells + w)
        elif g < w:
            ps.append(g + cells + w)
        out.append([[(j, p - j * b) for j in range(nb - 1, -1, -1)
                     if 0 <= p - j * b < e] for p in ps])
    return out


def _fold_by_rows(acc, cells, window, core):
    """The fold kernel's algorithm, one cube row at a time: F(px, py, pz) =
    0 + sum over ascending lx of (0 + sum over ascending ly of (0 + sum
    over ascending lz)); the row = its z padded coordinates' sum of (its
    y's sum of (its x's sum of F)), core first, then ring; every add in
    acc's dtype."""
    b, _, p_size, c = acc.shape
    (nbx, nby, nbz), (ex, ey, ez) = BL.block_geometry(cells, window, core)
    axes = [_axis_entries(cells, window, bs, e, nb)
            for bs, e, nb in zip(core, (ex, ey, ez), (nbx, nby, nbz))]
    zero = acc.new_zeros(c)
    out = acc.new_empty(b, cells ** 3, c)
    for s in range(b):
        for x in range(cells):
            for y in range(cells):
                for z in range(cells):
                    zsum = None
                    for zs in axes[2][z]:
                        ysum = None
                        for ys in axes[1][y]:
                            xsum = None
                            for xs in axes[0][x]:
                                f = zero
                                for jx, lx in xs:
                                    fy = zero
                                    for jy, ly in ys:
                                        fz = zero
                                        for jz, lz in zs:
                                            blk = (jx * nby + jy) * nbz + jz
                                            fz = fz + acc[s, blk, (lx * ey + ly) * ez + lz]
                                        fy = fy + fz
                                    f = f + fy
                                xsum = f if xsum is None else xsum + f
                            ysum = xsum if ysum is None else ysum + xsum
                        zsum = ysum if zsum is None else zsum + ysum
                    out[s, (x * cells + y) * cells + z] = zsum
    return out


def _patch_sums(cells, window, core, c, dtype, seed):
    """Random per-block sums, a fifth of them -0.0 (the plain version's
    sums start from +0)."""
    (nbx, nby, nbz), (ex, ey, ez) = BL.block_geometry(cells, window, core)
    g = torch.Generator().manual_seed(seed)
    acc = torch.randn(1, nbx * nby * nbz, ex * ey * ez, c, generator=g).to(dtype)
    neg0 = torch.rand(acc.shape, generator=g) < 0.2
    return torch.where(neg0, torch.tensor(-0.0, dtype=dtype), acc)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cells", [8, 16])
@pytest.mark.parametrize("c", [1, 6, 9, 64])
@pytest.mark.parametrize("window", [2, 3])
@pytest.mark.parametrize("core", CORES)
def test_fold_by_rows_is_the_plain_fold(core, window, c, cells, dtype):
    """The kernel's per-row tree equals patches_fold_plain bit for bit,
    zero signs included, at cubes of 8 (the smallest each core tiles,
    where the pad rings wrap the most) and 16."""
    acc = _patch_sums(cells, window, core, c, dtype, seed=cells * 100 + c)
    want = BL.patches_fold_plain(acc, cells, window, core)
    got = _fold_by_rows(acc, cells, window, core)
    assert got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("core", CORES + [(2, 2, 2)])
def test_cpu_wrappers_are_the_plain_versions(core, dtype):
    """On CPU tensors the wrappers, and ops/blocked.py's autograd pair
    over them, give the plain versions' results; no launch is counted."""
    cells, window, c = 8, 2, 5
    g = torch.Generator().manual_seed(3)
    values = torch.randn(2, cells ** 3, c, generator=g).to(dtype)
    before = tracing.counters()
    patches = BL.block_patches(values, cells, window, core)
    want = BL.block_patches_plain(values, cells, window, core)
    assert torch.equal(_bits(patches), _bits(want))
    assert torch.equal(_bits(blocked.block_patches(values, cells, window, core)),
                       _bits(want))
    acc = torch.randn(want.shape, generator=g).to(dtype)
    fold = BL.patches_fold_plain(acc, cells, window, core)
    assert torch.equal(_bits(BL.patches_fold(acc, cells, window, core)), _bits(fold))
    assert torch.equal(_bits(blocked.patches_fold(acc, cells, window, core)),
                       _bits(fold))
    assert not any(k.startswith("launch.block_patches")
                   or k.startswith("launch.patches_fold")
                   for k in tracing.delta(before))


def test_checks_take_the_route_shapes():
    """The checks pass what the masked routes hand the kernels."""
    for cells, core in ((64, (4, 8, 8)), (32, (8, 8, 8)), (32, (4, 4, 8)), (8, (8, 8, 8))):
        (nbx, nby, nbz), (ex, ey, ez) = BL.block_geometry(cells, 2, core)
        BL.check_patches(torch.empty(2, cells ** 3, 3), cells, 2, core)
        for dt in BL.FOLD_DTYPES:
            BL.check_fold(torch.empty(2, nbx * nby * nbz, ex * ey * ez, 1, dtype=dt),
                          cells, 2, core)


@pytest.mark.parametrize("args, match", [
    ((torch.empty(2, 8 ** 3 - 1, 3), 8, 2, (4, 8, 8)), r"\(B, 512, C\)"),
    ((torch.empty(8 ** 3, 3), 8, 2, (4, 8, 8)), r"\(B, 512, C\)"),
    ((torch.empty(2, 8 ** 3, 3), 8, 2, (3, 8, 8)), "does not tile"),
    ((torch.empty(2, 4 ** 3, 3), 4, 3, (4, 4, 4)), "window <= cells / 2"),
    ((torch.empty(2, 8 ** 3, 3), 8, -1, (4, 8, 8)), "window <= cells / 2"),
    ((torch.empty(2, 8 ** 3, 3), 8, 2, (4, 8)), "three positive sides"),
    ((torch.empty(2, 8 ** 3, 3), 8, 2, (0, 8, 8)), "three positive sides"),
])
def test_check_patches_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        BL.check_patches(*args)


@pytest.mark.parametrize("acc, match", [
    (torch.empty(2, 2, 1152, 3, dtype=torch.float64), "float32 or bfloat16"),
    (torch.empty(2, 2, 1152, 3, dtype=torch.float16), "float32 or bfloat16"),
    (torch.empty(2, 2, 1151, 3), r"\(B, 2, 1152, C\)"),
    (torch.empty(2, 4, 1152, 3), r"\(B, 2, 1152, C\)"),
    (torch.empty(2, 1152, 3), r"\(B, 2, 1152, C\)"),
])
def test_check_fold_refuses(acc, match):
    with pytest.raises(ValueError, match=match):
        BL.check_fold(acc, 8, 2, (4, 8, 8))
    with pytest.raises(ValueError, match="window <= cells / 2"):
        BL.check_fold(torch.empty(2, 1, 512, 3), 4, 3, (4, 4, 4))


@pytest.mark.parametrize("c, dtype, offset, want_bytes, want_elems", [
    (64, torch.bfloat16, 0, 16, 8),
    (64, torch.float32, 0, 16, 4),
    (9, torch.bfloat16, 0, 2, 1),
    (6, torch.bfloat16, 0, 4, 2),
    (6, torch.float32, 0, 8, 2),
    (9, torch.float32, 0, 4, 1),
    (1, torch.float32, 0, 4, 1),
    (64, torch.bfloat16, 1, 2, 1),
    (64, torch.float32, 2, 8, 2),
])
def test_vector_widths_divide_rows_and_alignment(c, dtype, offset, want_bytes,
                                                 want_elems):
    """Both kernels take the widest access that divides the row and every
    buffer's address: 16 bytes at C 64, an element at C 9 in bf16."""
    base = torch.empty(4096 + 16, dtype=dtype)
    aligned = base[(-base.data_ptr() % 16) // base.element_size():]
    t = aligned[offset:]
    row = c * t.element_size()
    assert BL.vec_bytes(row, t, aligned) == want_bytes
    assert BL.vec_elements(c, t, aligned) == want_elems


@pytest.mark.parametrize("units, row_bytes, p_size, want", [
    (8, 128, 1152, (8, 4)),      # C 64 bf16 at core (4, 8, 8): 32 sites a block
    (16, 256, 1152, (16, 4)),    # C 64 f32
    (9, 18, 1152, (9, 32)),      # C 9 bf16, 2-byte vectors
    (1, 4, 1152, (1, 5)),        # C 1 f32: a patch in one block
    (512, 8192, 1728, (256, 2)),  # a row wider than a block
])
def test_build_tiling(units, row_bytes, p_size, want):
    """A thread a vector of a row, as many sites a thread as let a block
    copy about 16 KiB, never more than the patch."""
    assert BL.build_tiling(units, row_bytes, p_size) == want


@pytest.mark.parametrize("units, vec_bytes, want", [
    (8, 16, 8), (16, 16, 16), (2, 16, 2), (512, 16, 256),
    (3, 8, 1), (9, 4, 1), (9, 2, 1), (1, 4, 1), (17, 4, 17),
])
def test_fold_lanes(units, vec_bytes, want):
    """A thread a 16-byte vector; one thread a row of narrower vectors."""
    assert BL.fold_lanes(units, vec_bytes) == want


def test_kernel_names_fall_in_the_other_bucket():
    """The kernels' names match no bucket pattern of the benchmark (so
    they count in elementwise_ms, in the place of the passes they
    replace, and stay out of the D/E buckets the rooflines divide by),
    in the forms a profile shows them."""
    text = SOURCE.read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)\(", text)
    assert sorted(kernels) == ["patch_build_kernel", "patch_fold_kernel",
                               "patch_fold_loop_kernel"]
    for name in kernels:
        for form in (name, f"void (anonymous namespace)::{name}<uint4>(uint4 const*, "
                           f"uint4*, long long, int, (anonymous namespace)::Geometry)",
                     f"void (anonymous namespace)::{name}<unsigned short, 8>"
                     f"(unsigned short const*, unsigned short*, int, int, "
                     f"(anonymous namespace)::Geometry)",
                     f"void__anonymous_namespace_::{name}_float__4_"):
            assert bucket_of(form) == "other", form


CELLS = 8


def _counted_step(family, channels, velocity, monkeypatch, **route):
    """Launches of the two wrappers in one forward + backward of a bf16
    model on `route` (the wrappers counted as the card counts a launch)."""
    for name in ("block_patches", "patches_fold"):
        def counted(x, *args, _orig=getattr(BL, name), _name=name):
            tracing.count(f"launch.{_name}")
            return _orig(x, *args)
        monkeypatch.setattr(BL, name, counted)
    raw = synthetic_raw_cubes(2, CELLS, seed=1)
    x_in, y = split_batch(torch.from_numpy(features_from_raw(
        raw, include_velocity=velocity)), 9 if velocity else 6)
    model = build_model(C.ModelConfig(
        family=family, channels=channels, k_neighbors=6, knn_window=2,
        dtype="bfloat16", **route), box=4.0 * CELLS, device="cpu")
    before = tracing.counters()
    (model(x_in).float() * y).sum().backward()
    return collections.Counter({k[len("launch."):]: v for k, v in
                                tracing.delta(before).items()
                                if k in ("launch.block_patches", "launch.patches_fold")})


@pytest.mark.parametrize("family, channels, velocity, route, want", [
    # the features' gather and 6 forward + 5 backward gathers (D); the
    # counts, 6 forward scatter-means and 5 gradients of the gathers (E)
    ("shiftinv_vel", (9, 32, 64, 64, 32, 16, 6), True, {"mask_dtype": "index"}, 12),
    # as D and E of the 15-op index step (core (8, 8, 8))
    ("shiftinv15", (3, 32, 64, 64, 32, 16, 3), False,
     {"mask_dtype": "index", "masked_core": (8, 8, 8)}, 13),
    ("shiftinv", (3, 32, 64, 64, 32, 16, 3), False, {"mask_dtype": "int8"}, 12),
    ("shiftinv", (3, 32, 64, 64, 32, 16, 3), False, {"neighbor_impl": "block"}, 12),
    ("shiftinv", (3, 32, 64, 64, 32, 16, 3), False, {}, 0),
])
def test_step_launches(family, channels, velocity, route, want, monkeypatch):
    """One train step launches each kernel once a D/F/H gather and once an
    E/G/I scatter or count; a direct-route step launches neither."""
    got = _counted_step(family, channels, velocity, monkeypatch, **route)
    assert got == ({"block_patches": want, "patches_fold": want} if want else {})
