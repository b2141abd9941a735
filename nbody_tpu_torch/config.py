"""Configuration: dataclasses + reference-compatible CLI (port of
nbody_tpu/config.py).

The constants and flag names are the JAX package's.  The dataclasses hold
only what the port runs; every flag of a path the port does not run yet
(sharding, ensembles, the scan and device-data loops, streaming, restore,
tracing, rematerialization, the TPU mask encodings, other model families)
raises NotImplementedError when set to a non-default value instead of
being ignored.  ROADMAP.md lists what waits.

The neighbor routes: ``--impl masked`` (the default) runs the direct
kernels B/C, or with ``--mask_dtype index`` the masked index route
(kernels D/E, core ``--masked_core``); ``--impl block`` runs the block
kernels F/G.  The TPU's one-hot mask encodings (``--mask_dtype auto`` as
einsum masks, int8, int4) and ``--impl banded`` are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Dataset constants (reference utils.py:142-153, 530-545)
# ---------------------------------------------------------------------------
NUM_SAMPLES = 1000
CELLS_PER_SIDE = 32
NUM_PARTICLES = CELLS_PER_SIDE ** 3
DATASET_SEED = 12345
BOX_SIZE = 128.0                              # raw grid spans [2, 126] step 4
GRID_OFFSET = 64.0

# 19-column raw cube schema (reference utils.py:530-545)
COL_ZA_DISP = slice(1, 4)
COL_2LPT_DISP = slice(4, 7)
COL_FPM_DISP = slice(7, 10)
COL_ZA_VEL = slice(10, 13)
COL_2LPT_VEL = slice(13, 16)
COL_FPM_VEL = slice(16, 19)

REDSHIFTS = [9.0000, 4.7897, 3.2985, 2.4950, 1.9792, 1.6141, 1.3385,
             1.1212, 0.9438, 0.7955, 0.6688, 0.5588, 0.4620, 0.3758,
             0.2983, 0.2280, 0.1639, 0.1049, 0.0505, 0.0000]

# ---------------------------------------------------------------------------
# Model constants (reference utils.py:156-202)
# ---------------------------------------------------------------------------
PARAMS_SEED = 77743196
CHANNELS = [6, 64, 128, 128, 256, 64, 128, 16, 3]
GRAPH_CHANNELS = [3, 32, 64, 64, 32, 16, 3]
GRAPH_VEL_CHANNELS = [9, 32, 64, 64, 32, 16, 6]
ATTN_CHANNELS = [6] + [16] * 22 + [3]
NUM_NEIGHBORS = 14
BIAS_INIT = 1e-8
SCALAR_INIT = 0.002

BATCH_SIZE = 4
NUM_ITERS = 20000
NUM_TEST_SAMPLES = 200
LEARN_RATE = 0.01
NUM_VAL_SAMPLES = 100

MODEL_NAME_ZA = "ZA-FPM_{}"
CUBE_NAME = "X_{}"
MODEL_TAGLIST = ["arae", "boot", "cari", "drac", "erid", "forn", "gemi",
                 "hyda", "indi", "lyra", "mensa", "norma", "orion", "pavo",
                 "reti", "scut", "taur", "ursa", "virgo"]

MODEL_FAMILIES = ("set", "shiftinv", "shiftinv15", "attn", "shiftinv_vel")
# families the port runs; the others raise NotImplementedError
PORTED_FAMILIES = ("shiftinv", "shiftinv_vel")
DTYPES = ("float32", "bfloat16")
NEIGHBOR_IMPLS = ("masked", "block")          # "banded" is not ported
MASK_DTYPES = ("auto", "index")               # int8/int4 are not ported


def default_data_dir() -> str:
    return os.environ.get(
        "NBODY_DATA_DIR",
        os.path.join(os.environ.get("HOME", "."), ".Data", "nbody_simulations", "ZA"))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection + split (reference Dataset, utils.py:547-621)."""
    data_dir: str = dataclasses.field(default_factory=default_data_dir)
    data_idx: int = 0
    num_test: int = NUM_TEST_SAMPLES
    num_val: int = NUM_VAL_SAMPLES
    seed: int = DATASET_SEED
    cells_per_side: int = CELLS_PER_SIDE
    # joint position+velocity task (9 input channels, 6 target channels)
    include_velocity: bool = False
    synthetic_num_samples: int = NUM_SAMPLES


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    family: str = "shiftinv"
    channels: Tuple[int, ...] = tuple(GRAPH_CHANNELS)
    k_neighbors: int = NUM_NEIGHBORS
    seed: int = PARAMS_SEED
    dtype: str = "float32"                    # compute dtype for activations
    # lattice kNN search window in grid cells (ops/knn.py)
    knn_window: int = 3
    # neighbor route: "masked" = direct kernels B/C, or the index route
    # with mask_dtype "index"; "block" = block kernels F/G
    neighbor_impl: str = "masked"
    # first-choice core of the index route (None: ops/blocked.MASKED_CORE)
    masked_core: Optional[Tuple[int, int, int]] = None
    # "index": per-edge patch positions + kernels D/E (bf16 compute only;
    # float32 downgrades to the direct route, recorded)
    mask_dtype: str = "auto"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_iters: int = NUM_ITERS
    batch_size: int = BATCH_SIZE
    learn_rate: float = LEARN_RATE
    checkpoint_every: int = 250               # reference train.py:29
    name: str = ""


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def build_parser() -> argparse.ArgumentParser:
    """Reference-compatible CLI (reference utils.py:242-271), with the JAX
    package's framework flags.  Flags of unported paths are still parsed
    so that config_from_args can refuse them by name."""
    p = argparse.ArgumentParser(
        description="Train an N-body ZA->FastPM correction model "
                    "(PyTorch / CUDA port).",
        formatter_class=argparse.RawTextHelpFormatter)
    adg = p.add_argument
    adg("-c", "--channels", type=int, nargs="+", default=list(CHANNELS),
        metavar="C", help="List of ints that define layer sizes")
    adg("-i", "--num_iters", type=int, default=NUM_ITERS, metavar="N",
        help="Number of training iterations")
    adg("-b", "--batch_size", type=int, default=BATCH_SIZE, metavar="B",
        help="Number of samples per training batch")
    adg("-d", "--data_idx", type=int, default=0, metavar="i",
        help="Index of the dataset file (ZA_001.npy ... ZA_010.npy)")
    adg("-k", "--kneighbors", type=int, default=NUM_NEIGHBORS, metavar="K",
        help="Number of neighbors in graph model (KNN); K == -1 selects set model")
    adg("-n", "--name", type=str, default="", metavar="name",
        help="Name for model; randomly generated if not specified")
    adg("-s", "--seed", type=int, default=PARAMS_SEED, metavar="X",
        help="Random seed for parameter initialization")
    adg("-l", "--learnrate", type=float, default=LEARN_RATE, metavar="lr",
        help="Learning rate for optimizer")
    adg("-t", "--num_test", type=int, default=NUM_TEST_SAMPLES, metavar="M",
        help="Number of samples in test set")
    adg("--model", type=str, default=None, choices=list(MODEL_FAMILIES),
        help="Model family; default: 'shiftinv_vel' with --velocity, else "
             "'set' if -k == -1 else 'shiftinv' (the port runs shiftinv "
             "and shiftinv_vel)")
    adg("--data_dir", type=str, default=None, help="Directory with ZA_*.npy cubes")
    adg("--synthetic", action="store_true",
        help="Force synthetic data even if real cubes exist")
    adg("--velocity", action="store_true",
        help="Joint position+velocity task (9 input, 6 target channels; "
             "model shiftinv_vel)")
    adg("--streaming", action="store_true", help="(not ported) mmap streaming")
    adg("--cells", type=int, default=CELLS_PER_SIDE,
        help="Cube cells per side (particles = cells^3)")
    adg("--samples", type=int, default=NUM_SAMPLES, metavar="S",
        help="Synthetic dataset size (cubes generated when no real data)")
    adg("-r", "--restore", action="store_true", help="(not ported) restore")
    adg("--scan", type=int, default=0, metavar="T", help="(not ported)")
    adg("--device_data", type=str, default="auto",
        choices=["auto", "on", "off"], help="(not ported)")
    adg("--masked_core", type=int, nargs=3, default=None, metavar="D",
        help="Core block shape of the --mask_dtype index route (3 ints); "
             "default (4, 8, 8), stepping down to one that tiles the cube")
    adg("--impl", type=str, default="masked",
        choices=["masked", "block", "banded"],
        help="Neighbor gather/scatter: 'masked' runs the direct CUDA "
             "kernels (or the index route with --mask_dtype index), "
             "'block' the 3D-block kernels; 'banded' is not ported")
    adg("--mask_dtype", type=str, default="auto",
        choices=["auto", "int8", "int4", "index"],
        help="'index': per-edge patch positions and the block-selection "
             "kernels (bf16; float32 runs the direct kernels); "
             "int8/int4 are not ported")
    adg("--remat", action="store_true", help="(not ported)")
    adg("--knn_select", type=str, default="sort",
        choices=["sort", "iter", "pallas"],
        help="Lattice kNN k-selection.  The three JAX choices return the "
             "same slots in the same order; the port runs every one of "
             "them through its CUDA selection kernel (ops/kernels/"
             "topk_kernels.py)")
    adg("--knn_window", type=int, default=3, metavar="W",
        help="Lattice kNN search window in grid cells (the coverage guard "
             "verifies it)")
    adg("--dtype", type=str, default="float32", choices=list(DTYPES),
        help="Compute dtype for activations (params/optimizer stay f32)")
    adg("--ensemble", type=int, default=0, metavar="E", help="(not ported)")
    adg("--data_axis", type=int, default=1, help="(not ported)")
    adg("--particle_axis", type=int, default=1, help="(not ported)")
    adg("--platform", type=str, default="cuda", choices=["cuda", "cpu"],
        help="Torch device to run on; cuda fails when no card is present")
    adg("--trace", type=str, default="", metavar="DIR", help="(not ported)")
    return p


# flag -> default: a non-default value names a path the port does not run
_UNPORTED_FLAGS = {
    "ensemble": 0, "data_axis": 1, "particle_axis": 1, "streaming": False,
    "scan": 0, "device_data": "auto", "restore": False, "trace": "",
    "remat": False,
}


def _not_ported(flag: str, value):
    return NotImplementedError(f"--{flag}={value!r} is not ported to "
                               "nbody_tpu_torch yet (ROADMAP.md)")


def config_from_args(args: argparse.Namespace) -> Config:
    for flag, default in _UNPORTED_FLAGS.items():
        if getattr(args, flag) != default:
            raise _not_ported(flag, getattr(args, flag))
    if args.impl not in NEIGHBOR_IMPLS:
        raise _not_ported("impl", args.impl)
    if args.mask_dtype not in MASK_DTYPES:
        raise _not_ported("mask_dtype", args.mask_dtype)
    if args.masked_core is not None and args.mask_dtype != "index":
        # without the index route it would size the TPU einsum masks
        raise _not_ported("masked_core", args.masked_core)
    family = args.model
    if family is None:
        if args.velocity:
            family = "shiftinv_vel"
        else:
            family = "set" if args.kneighbors == -1 else "shiftinv"
    check_family(family)
    if args.velocity != (family == "shiftinv_vel"):
        raise ValueError("--velocity trains the shiftinv_vel family and "
                         f"shiftinv_vel needs it; got family {family!r}")
    data_dir = args.data_dir or default_data_dir()
    if args.synthetic:
        data_dir = os.path.join(os.path.sep, "nonexistent-force-synthetic")
    data = DataConfig(
        data_dir=data_dir,
        data_idx=args.data_idx,
        num_test=args.num_test,
        # as the JAX CLI: the reference's fixed 100 val cubes scaled to 10%
        num_val=min(NUM_VAL_SAMPLES, max(1, args.samples // 10)),
        cells_per_side=args.cells,
        include_velocity=args.velocity,
        synthetic_num_samples=args.samples)
    model = ModelConfig(
        family=family,
        channels=tuple(args.channels),
        k_neighbors=(args.kneighbors if args.kneighbors > 0 else NUM_NEIGHBORS),
        seed=args.seed,
        knn_window=args.knn_window,
        neighbor_impl=args.impl,
        masked_core=(tuple(args.masked_core) if args.masked_core else None),
        mask_dtype=args.mask_dtype,
        dtype=args.dtype)
    train = TrainConfig(
        num_iters=args.num_iters,
        batch_size=args.batch_size,
        learn_rate=args.learnrate,
        name=args.name)
    return Config(data=data, model=model, train=train)


def check_family(family: str):
    if family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family: {family!r}")
    if family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {family!r} is not ported to nbody_tpu_torch yet "
            "(ROADMAP.md Queue 1)")


def check_model_config(cfg: ModelConfig):
    """Refuse what the port cannot run: unknown or unported families,
    dtypes, neighbor routes and mask encodings."""
    check_family(cfg.family)
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {cfg.dtype!r}")
    if cfg.neighbor_impl not in NEIGHBOR_IMPLS:
        raise NotImplementedError(
            f"neighbor_impl {cfg.neighbor_impl!r} is not ported (ROADMAP.md)")
    if cfg.mask_dtype not in MASK_DTYPES:
        raise NotImplementedError(
            f"mask_dtype {cfg.mask_dtype!r} is not ported (ROADMAP.md)")
