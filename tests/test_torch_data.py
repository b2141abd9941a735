"""Port parity: config, data, physics (nbody_tpu_torch vs nbody_tpu).

Same numpy-seeded inputs through both packages; cubes, features and the
split must be bit-identical, PBC math bit-equal, losses to f32 rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nbody_tpu import config as JC
from nbody_tpu.data import dataset as jdata
from nbody_tpu.data.grid import grid_positions_np as j_grid_np
from nbody_tpu.data.synthetic import synthetic_raw_cubes as j_synth
from nbody_tpu.physics import losses as jloss
from nbody_tpu.physics import pbc as jpbc

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data import dataset as tdata
from nbody_tpu_torch.data.grid import grid_positions, grid_positions_np
from nbody_tpu_torch.data.synthetic import synthetic_raw_cubes
from nbody_tpu_torch.physics import losses as tloss
from nbody_tpu_torch.physics import pbc as tpbc

torch.set_num_threads(1)


@pytest.mark.parametrize("cells,seed", [(8, 0), (8, 7), (16, 3)])
def test_synthetic_cubes_bit_identical(cells, seed):
    np.testing.assert_array_equal(synthetic_raw_cubes(3, cells, seed=seed),
                                  j_synth(3, cells, seed=seed))


def test_synthetic_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("NBODY_SYNTH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("NBODY_SYNTH_CACHE_MIN", "1")
    first = synthetic_raw_cubes(2, 8, seed=4)
    assert len(list(tmp_path.glob("synth_2x8_s4_*.npy"))) == 1
    np.testing.assert_array_equal(synthetic_raw_cubes(2, 8, seed=4), first)
    np.testing.assert_array_equal(first, j_synth(2, 8, seed=4))


@pytest.mark.parametrize("cells", [8, 32])
def test_grid_positions_match(cells):
    box = 4.0 * cells
    want = j_grid_np(cells, box=box)
    np.testing.assert_array_equal(grid_positions_np(cells, box=box), want)
    np.testing.assert_array_equal(grid_positions(cells, box=box).numpy(), want)


def test_features_and_split_bit_identical():
    raw = j_synth(12, 8, seed=2)
    x = tdata.features_from_raw(raw)
    np.testing.assert_array_equal(x, jdata.features_from_raw(raw))
    for got, want in zip(tdata.split_dataset(x, 3, 2, seed=9),
                         jdata.split_dataset(x, 3, 2, seed=9)):
        np.testing.assert_array_equal(got, want)


def test_dataset_matches_jax_dataset():
    raw = j_synth(10, 8, seed=1)
    tds = tdata.Dataset(C.DataConfig(num_test=2, num_val=2, seed=5), raw=raw)
    jds = jdata.Dataset(JC.DataConfig(num_test=2, num_val=2, seed=5), raw=raw)
    for name in ("X_train", "X_val", "X_test"):
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name))
    assert (tds.cells, tds.box, tds.num_particles) == (8, 32.0, 512)
    # the minibatch stream is a seeded numpy Generator: reproducible
    a = [tds.get_minibatch_indices(tds.minibatch_rng(), 3) for _ in range(2)]
    np.testing.assert_array_equal(a[0], a[1])
    assert len(set(a[0].tolist())) == 3
    batches = list(tds.sequential_batches("test", 1))
    assert [p for p, _ in batches] == [0, 1]
    x_in, y = tdata.split_batch(torch.from_numpy(tds.X_test))
    assert x_in.shape[-1] == 6 and y.shape[-1] == 3


def test_dataset_synthetic_fallback(tmp_path):
    cfg = C.DataConfig(data_dir=str(tmp_path), num_test=1, num_val=1,
                       cells_per_side=8, synthetic_num_samples=5, seed=3)
    ds = tdata.make_dataset(cfg)
    assert np.concatenate([ds.X_train, ds.X_val, ds.X_test]).shape == (5, 512, 9)
    np.save(tmp_path / "ZA_001.npy", j_synth(4, 8, seed=6))
    ds2 = tdata.make_dataset(cfg)
    assert ds2.X_train.shape[0] == 2


@pytest.mark.parametrize("box", [1.0, 32.0])
def test_pbc_bit_equal(box):
    rng = np.random.default_rng(0)
    a = (rng.random((4096, 3)) * 3 * box - box).astype(np.float32)
    b = (rng.random((4096, 3)) * box).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        tpbc.min_image_diff(ta, tb, box).numpy(),
        np.asarray(jpbc.min_image_diff(jnp.asarray(a), jnp.asarray(b), box)))
    np.testing.assert_array_equal(
        tpbc.min_image_sq_dist(ta, tb, box).numpy(),
        np.asarray(jpbc.min_image_sq_dist(jnp.asarray(a), jnp.asarray(b), box)))
    np.testing.assert_array_equal(
        tpbc.wrap_coords(ta, box).numpy(),
        np.asarray(jpbc.wrap_coords(jnp.asarray(a), box)))


def test_losses_match():
    rng = np.random.default_rng(1)
    p, t = (rng.normal(size=(2, 512, 3)).astype(np.float32) for _ in range(2))
    tp, tt = torch.from_numpy(p), torch.from_numpy(t)
    np.testing.assert_allclose(float(tloss.loss_za(tp, tt)),
                               float(jloss.loss_za(p, t)), rtol=1e-6)
    np.testing.assert_allclose(float(tloss.mse_za(tp, tt)),
                               float(jloss.mse_za(p, t)), rtol=1e-6)


def test_constants_match_jax():
    for name in ("NUM_SAMPLES", "CELLS_PER_SIDE", "DATASET_SEED", "BOX_SIZE",
                 "PARAMS_SEED", "CHANNELS", "GRAPH_CHANNELS", "NUM_NEIGHBORS",
                 "BIAS_INIT", "BATCH_SIZE", "NUM_ITERS", "NUM_TEST_SAMPLES",
                 "LEARN_RATE", "NUM_VAL_SAMPLES", "REDSHIFTS",
                 "MODEL_FAMILIES", "MODEL_NAME_ZA", "CUBE_NAME",
                 "MODEL_TAGLIST"):
        assert getattr(C, name) == getattr(JC, name), name


def test_parser_reference_flags():
    args = C.build_parser().parse_args(
        ["-c", "3", "8", "3", "-i", "7", "-b", "2", "-k", "6", "-s", "11",
         "-l", "0.003", "-t", "2", "--cells", "8", "--samples", "30",
         "--synthetic", "--knn_window", "2", "--dtype", "bfloat16",
         "--platform", "cpu"])
    cfg = C.config_from_args(args)
    assert cfg.model == C.ModelConfig(family="shiftinv", channels=(3, 8, 3),
                                      k_neighbors=6, seed=11, dtype="bfloat16",
                                      knn_window=2)
    assert (cfg.train.num_iters, cfg.train.batch_size,
            cfg.train.learn_rate) == (7, 2, 0.003)
    assert (cfg.data.cells_per_side, cfg.data.num_test, cfg.data.num_val,
            cfg.data.synthetic_num_samples) == (8, 2, 3, 30)
    assert "nonexistent" in cfg.data.data_dir
    assert C.build_parser().parse_args([]).platform == "cuda"
    with pytest.raises(SystemExit):
        C.build_parser().parse_args(["--platform", "auto"])


@pytest.mark.parametrize("flags", [
    ["--impl", "banded", "--data_axis", "2"], ["--ensemble", "2"],
    ["--data_axis", "2"], ["--particle_axis", "2"], ["--streaming"],
    # the run flags are ported; beside a refused flag they still raise
    ["--scan", "5", "--ensemble", "2"], ["--device_data", "on", "--data_axis", "2"],
    ["-r", "--streaming"], ["--trace", "t", "--particle_axis", "2"],
    ["--masked_core", "4", "4", "4"], ["--remat", "--streaming"],
    ["--model", "shiftinv15", "--ensemble", "2"],
    ["--remat", "--particle_axis", "2"]])
def test_unported_flags_raise(flags):
    args = C.build_parser().parse_args(flags)
    with pytest.raises(NotImplementedError):
        C.config_from_args(args)


@pytest.mark.parametrize("flags,field,value", [
    (["--impl", "banded"], "neighbor_impl", "banded"),
    (["--remat"], "remat", True),
    (["--model", "shiftinv15"], "family", "shiftinv15"),
    (["--velocity", "--remat"], "remat", True)])
def test_ported_graph_flags_configure_and_build(flags, field, value):
    """--impl banded, --remat and --model shiftinv15 configure with the JAX
    CLI's meaning, and the model builds (on the CPU)."""
    from nbody_tpu_torch.models.registry import build_model
    cfg = C.config_from_args(C.build_parser().parse_args(flags))
    assert getattr(cfg.model, field) == value
    jcfg = JC.config_from_args(JC.build_parser().parse_args(flags))
    assert getattr(jcfg.model, field) == value
    model = build_model(cfg.model, device="cpu")
    assert model.cfg == cfg.model


@pytest.mark.parametrize("flags,family", [
    (["--model", "attn"], "attn"), (["--model", "set"], "set"),
    (["-k", "-1"], "set")])
def test_set_and_attn_flags_configure_and_build(flags, family):
    """The set and attn families are ported: their flags configure, with
    the parser's CHANNELS and K 14 for -k -1 (as JAX), and the model
    builds."""
    from nbody_tpu_torch.models.registry import build_model
    cfg = C.config_from_args(C.build_parser().parse_args(flags))
    assert cfg.model.family == family
    assert cfg.model.channels == tuple(C.CHANNELS)
    assert cfg.model.k_neighbors == C.NUM_NEIGHBORS
    model = build_model(cfg.model, device="cpu")
    assert model.cfg.family == family and len(model.params) == len(C.CHANNELS) - 1


def test_run_flags_reach_train_config(monkeypatch):
    """-n, -r, --scan and --device_data reach TrainConfig with the JAX
    CLI's meaning; the defaults are the JAX TrainConfig's, and the
    experiments directory follows the same variable."""
    args = C.build_parser().parse_args(
        ["-n", "foo", "-r", "--scan", "5", "--device_data", "on",
         "--trace", "t"])
    train = C.config_from_args(args).train
    assert (train.name, train.restore, train.scan_chunk,
            train.device_data) == ("foo", True, 5, "on")
    assert args.trace == "t"
    default = C.config_from_args(C.build_parser().parse_args([])).train
    jdefault = JC.TrainConfig()
    for field in ("name", "restore", "scan_chunk", "device_data",
                  "experiments_dir", "checkpoint_every"):
        assert getattr(default, field) == getattr(jdefault, field), field
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", "/some/where")
    assert C.default_experiments_dir() == JC.default_experiments_dir() == "/some/where"
    monkeypatch.delenv("NBODY_EXPERIMENTS_DIR")
    assert C.default_experiments_dir() == JC.default_experiments_dir()


def test_knn_select_values_accepted():
    for sel in ("sort", "iter", "pallas"):
        args = C.build_parser().parse_args(["--knn_select", sel])
        assert C.config_from_args(args).model.family == "shiftinv"
