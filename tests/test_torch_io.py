"""Checkpoints, the Saver and --trace of the port (nbody_tpu_torch/io_,
cli/train.py) on the CPU, held against the JAX package's io_ and viz.

A checkpoint round trip restores params, Adam state and the global step
bit for bit, and one step after a restore equals one step of the
original trainer; the port's Saver writes the JAX Saver's file names and
metrics keys, and nbody_tpu/viz reads its cube.
"""

import json
import os
import random
import re

import numpy as np
import pytest
import torch

from nbody_tpu import config as JC
from nbody_tpu.io_ import checkpoint as jckpt
from nbody_tpu.io_.saver import Saver as JSaver
from nbody_tpu.io_.saver import random_model_tag as j_random_model_tag
from nbody_tpu.train.trainer import Trainer as JTrainer
from nbody_tpu.viz.plot_eval import load_cube

from nbody_tpu_torch import config as C
from nbody_tpu_torch.cli import train as cli_train
from nbody_tpu_torch.data.dataset import Dataset, split_batch
from nbody_tpu_torch.io_ import checkpoint
from nbody_tpu_torch.io_.saver import Saver, random_model_tag
from nbody_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CELLS = 8
NODATA = os.path.join(os.sep, "nonexistent")


def _cfg(**train):
    return C.Config(
        data=C.DataConfig(data_dir=NODATA, num_test=2, num_val=1,
                          cells_per_side=CELLS, synthetic_num_samples=9),
        model=C.ModelConfig(channels=(3, 8, 8, 3), k_neighbors=6,
                            knn_window=2, seed=4),
        train=C.TrainConfig(batch_size=2, learn_rate=1e-3, **train))


@pytest.fixture(scope="module")
def dataset():
    return Dataset(_cfg().data)


def _adam_state(trainer):
    return [(s["exp_avg"], s["exp_avg_sq"], s["step"])
            for s in trainer.optimizer.state.values()]


def test_checkpoint_round_trip_and_resume(tmp_path, dataset):
    """Params, Adam exp_avg / exp_avg_sq / step and the global step come
    back bit-equal, and the next step of the restored trainer equals the
    next step of the original on the same batch."""
    a = Trainer(_cfg(num_iters=3, checkpoint_every=10), "cpu", dataset=dataset)
    a.fit(verbose=False)
    path = checkpoint.save_checkpoint(str(tmp_path), a, a.step)
    assert os.path.basename(path) == "chkpt-3.pt"
    b = Trainer(_cfg(), "cpu", dataset=dataset)
    assert checkpoint.restore_checkpoint(str(tmp_path), b) == 3
    assert b.step == 3
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    for sa, sb in zip(_adam_state(a), _adam_state(b)):
        for ta, tb in zip(sa, sb):
            assert torch.equal(ta, tb)
    x, y = split_batch(torch.from_numpy(dataset.X_train[:2]))
    assert torch.equal(a.train_step(x, y), b.train_step(x, y))
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def test_restore_keeps_the_optimizers_capturable_setting(tmp_path, dataset):
    """A checkpoint written on the card holds a capturable Adam (its step
    count on the device); restored on the CPU, the optimizer keeps its
    own setting and steps as the original does."""
    a = Trainer(_cfg(num_iters=1), "cpu", dataset=dataset)
    a.fit(verbose=False)
    state = a.state_dict()
    for group in state["optimizer"]["param_groups"]:
        group["capturable"] = True          # as make_optimizer sets it on the card
    torch.save(state, tmp_path / "chkpt-1.pt")
    b = Trainer(_cfg(), "cpu", dataset=dataset)
    checkpoint.restore_checkpoint(str(tmp_path), b)
    assert [g["capturable"] for g in b.optimizer.param_groups] == [False]
    x, y = split_batch(torch.from_numpy(dataset.X_train[:2]))
    assert torch.equal(a.train_step(x, y), b.train_step(x, y))


def test_latest_step_and_refusals(tmp_path):
    assert checkpoint.latest_step(str(tmp_path)) is None
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path), None)
    # a JAX run's Session: orbax directories only
    os.makedirs(tmp_path / "chkpt-250")
    assert checkpoint.latest_step(str(tmp_path)) is None
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.restore_checkpoint(str(tmp_path), None)
    # and the JAX latest_step ignores the port's files
    for step in (5, 40):
        (tmp_path / f"chkpt-{step}.pt").write_bytes(b"")
    assert checkpoint.latest_step(str(tmp_path)) == 40
    assert jckpt.latest_step(str(tmp_path)) == 250


def test_random_model_tag_has_the_jax_format():
    assert random_model_tag(random.Random(7)) == j_random_model_tag(random.Random(7))
    names = random_model_tag().split("-")
    assert len(names) == 3 and all(n in JC.MODEL_TAGLIST for n in names)


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_saver_matches_the_jax_saver(tmp_path, dataset, capsys):
    """The same label, tag and arrays give the same relative file names
    under Results/, and a short run logs the same metrics.jsonl keys."""
    err = np.arange(3, dtype=np.float32)
    cube = np.ones((2, 2, CELLS ** 3, 3), np.float32)
    savers = {}
    for key, cls in (("jax", JSaver), ("port", Saver)):
        s = cls(3, model_tag="tag", experiments_dir=str(tmp_path / key))
        s.save_error(err)
        s.save_error(err, training=True)
        s.save_cube(cube)
        savers[key] = s
    assert savers["port"].name == savers["jax"].name == "ZA-FPM_3_tag"
    assert _listing(savers["port"].results) == _listing(savers["jax"].results)
    out = capsys.readouterr().out
    assert out.count("MODEL NAMED: ZA-FPM_3_tag") == 2

    jcfg = JC.Config(
        data=JC.DataConfig(data_dir=NODATA, num_test=2, num_val=1,
                           cells_per_side=CELLS, synthetic_num_samples=9),
        model=JC.ModelConfig(family="shiftinv", channels=(3, 8, 3),
                             k_neighbors=6, knn_window=2),
        train=JC.TrainConfig(num_iters=2, batch_size=2, checkpoint_every=2))
    cfg = _cfg(num_iters=2, checkpoint_every=2)
    keys = {}
    for key, trainer in (
            ("jax", JTrainer(jcfg, saver=savers["jax"])),
            ("port", Trainer(cfg, "cpu", dataset=dataset, saver=savers["port"]))):
        trainer.fit(verbose=False)
        path = os.path.join(os.path.dirname(trainer.saver.results), "metrics.jsonl")
        keys[key] = [sorted(json.loads(ln)) for ln in open(path)]
    assert keys["port"] == keys["jax"]


def test_viz_reads_the_port_cube(tmp_path, dataset):
    trainer = Trainer(_cfg(num_iters=1), "cpu", dataset=dataset)
    _, cube = trainer.evaluate(verbose=False)
    path = Saver(0, "viz", experiments_dir=str(tmp_path)).save_cube(cube)
    got = load_cube(path)
    assert got.shape == (2, 2, CELLS ** 3, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, cube)


def test_fit_checkpoints_at_the_global_step(tmp_path, dataset):
    """Checkpoints every checkpoint_every steps of fit and after every
    chunk of fit_scan, labelled with the global step, and every record in
    metrics.jsonl."""
    saver = Saver(0, "g", experiments_dir=str(tmp_path))
    t = Trainer(_cfg(num_iters=4, checkpoint_every=2), "cpu", dataset=dataset,
                saver=saver)
    t.fit(verbose=False)
    t.fit_scan(num_iters=3, scan_chunk=2, verbose=False)
    assert sorted(os.listdir(saver.params), key=lambda n: int(
        re.findall(r"\d+", n)[0])) == [f"chkpt-{s}.pt" for s in (2, 4, 6, 7)]
    with open(os.path.join(tmp_path, saver.name, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert recs == json.loads(json.dumps(t.metrics_log))


def test_cli_trace_writes_a_chrome_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("NBODY_EXPERIMENTS_DIR", str(tmp_path / "exp"))
    trace = tmp_path / "trace"
    assert cli_train.main([
        "--platform", "cpu", "--cells", "8", "-i", "2", "-b", "2", "-t", "2",
        "--samples", "8", "-k", "6", "--knn_window", "2", "-c", "3", "8", "3",
        "--synthetic", "-n", "t", "--trace", str(trace)]) == 0
    assert f"Profiler trace written to {trace}" in capsys.readouterr().out
    with open(trace / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
