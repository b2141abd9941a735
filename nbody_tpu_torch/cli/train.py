"""Training CLI (port of nbody_tpu/cli/train.py; reference train.py).

    python -m nbody_tpu_torch.cli.train --model shiftinv -k 14 --cells 32 \\
        --knn_window 2 --dtype bfloat16 --synthetic --samples 16 -t 4 -i 20
    python -m nbody_tpu_torch.cli.train --model shiftinv_vel --velocity \\
        --cells 64 -b 1 --dtype bfloat16 --knn_window 2 --mask_dtype index \\
        --synthetic --samples 8 -t 1 -i 20
    python -m nbody_tpu_torch.cli.train --platform cpu --cells 8 -i 4 ...

Runs fit, then evaluate on the test split, and prints the reference-style
results.  Saving .npy artifacts and checkpoints is not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nbody_tpu_torch import config as C
from nbody_tpu_torch.data.dataset import make_dataset
from nbody_tpu_torch.train.trainer import Trainer


def resolve_device(platform: str) -> torch.device:
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform cuda: no CUDA device is available "
                           "(use --platform cpu for the plain versions)")
    return torch.device(platform)


def print_evaluation_results(err: np.ndarray, label: str = "Test"):
    print("\n".join([f"\n# {label} Error\n# {'=' * 17}",
                     f"  median : {np.median(err): .5f}",
                     f"    mean : {np.mean(err): .5f} +- {np.std(err): .4f} stdv"]))


def main(argv=None) -> int:
    args = C.build_parser().parse_args(argv)
    cfg = C.config_from_args(args)
    device = resolve_device(args.platform)
    dataset = make_dataset(cfg.data)
    trainer = Trainer(cfg, device, dataset=dataset)
    name = f" {cfg.train.name}," if cfg.train.name else ""
    print(f"\nTraining{name} ({cfg.model.family}, N={dataset.num_particles}, "
          f"b={cfg.train.batch_size}, {cfg.model.dtype}, {device}):\n{'=' * 78}")
    t0 = time.time()
    trainer.fit()
    print(f"Training finished!\n\tElapsed time: {(time.time() - t0) / 60:.2f}m")
    print(f"\nEvaluation:\n{'=' * 78}")
    test_error, _ = trainer.evaluate("test")
    print_evaluation_results(test_error)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
