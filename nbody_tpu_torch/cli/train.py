"""Training CLI (port of nbody_tpu/cli/train.py; reference train.py).

    python -m nbody_tpu_torch.cli.train --model shiftinv -k 14 --cells 32 \\
        --knn_window 2 --dtype bfloat16 --synthetic --samples 16 -t 4 -i 20
    python -m nbody_tpu_torch.cli.train ... --scan 10 -n myrun    # fit_scan
    python -m nbody_tpu_torch.cli.train ... -r -n myrun           # resume
    python -m nbody_tpu_torch.cli.train ... --trace /tmp/trace    # profile
    python -m nbody_tpu_torch.cli.train --model shiftinv_vel --velocity \\
        --cells 64 -b 1 --dtype bfloat16 --knn_window 2 --mask_dtype index \\
        --synthetic --samples 8 -t 1 -i 20
    python -m nbody_tpu_torch.cli.train --platform cpu --cells 8 -i 4 ...

Runs fit (or fit_scan with --scan T), then evaluate on the test split,
step for step as the JAX CLI: a Saver names the run (a random tag without
-n, printed as MODEL NAMED) and receives the checkpoints, metrics.jsonl,
the training-error series, the result cube and the test errors; -r
restores the latest checkpoint first; --trace DIR writes a torch.profiler
chrome trace of the training loop to DIR/trace.json, which carries the
program's span names (tracing.py).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import make_dataset
from nbody_tpu_torch.io_.saver import Saver
from nbody_tpu_torch.models.registry import resolve_device
from nbody_tpu_torch.train.trainer import Trainer


def _train(trainer: Trainer, cfg: C.Config):
    if cfg.train.scan_chunk > 0:
        trainer.fit_scan(scan_chunk=cfg.train.scan_chunk)
    else:
        trainer.fit()


def _train_traced(trainer: Trainer, cfg: C.Config, trace_dir: str):
    """The training loop under torch.profiler (the JAX CLI's
    jax.profiler.start_trace); the chrome trace goes to DIR/trace.json."""
    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        _train(trainer, cfg)
    finally:
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        print(f"Profiler trace written to {trace_dir}")


def main(argv=None) -> int:
    args = C.build_parser().parse_args(argv)
    cfg = C.config_from_args(args)
    device = resolve_device(args.platform)

    saver = Saver(cfg.data.data_idx, model_tag=cfg.train.name,
                  experiments_dir=cfg.train.experiments_dir)
    dataset = make_dataset(cfg.data)
    trainer = Trainer(cfg, device, dataset=dataset, saver=saver)

    if cfg.train.restore:
        saver.restore_checkpoint(trainer)
        print(f"Restored checkpoint at step {trainer.step}")

    print(f"\nTraining ({cfg.model.family}, N={dataset.num_particles}, "
          f"b={cfg.train.batch_size}, {cfg.model.dtype}, {device}):\n{'=' * 78}")
    t0 = time.perf_counter()
    if args.trace:
        _train_traced(trainer, cfg, args.trace)
    else:
        _train(trainer, cfg)
    print(f"Training finished!\n\tElapsed time: {(time.perf_counter() - t0) / 60:.2f}m")
    saver.save_checkpoint(trainer, trainer.step)
    if trainer.train_error_history:
        # per-checkpoint training-error series (reference train.py:117-120,
        # utils.py:488-498 with training=True)
        saver.save_error(np.asarray(trainer.train_error_history, np.float32),
                         training=True)

    print(f"\nEvaluation:\n{'=' * 78}")
    test_error, test_predictions = trainer.evaluate("test")
    saver.save_cube(test_predictions)
    saver.save_error(test_error)
    saver.print_evaluation_results(test_error)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
