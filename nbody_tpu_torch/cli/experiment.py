"""Attention / residual model entry point with the reference's defaults
(port of nbody_tpu/cli/experiment.py; reference experiment.py:282-303):
lr 0.006, batch 10, 100k iterations, run name TEST, ATTN_CHANNELS (22
hidden layers of width 16).

    python -m nbody_tpu_torch.cli.experiment -i 20 --cells 16 --synthetic
    python -m nbody_tpu_torch.cli.experiment --platform cpu -i 4 --cells 8 --synthetic

Forwards to ``python -m nbody_tpu_torch.cli.train --model attn`` with
these defaults, as the JAX entry point forwards to its train CLI.
"""

from __future__ import annotations

import argparse

from nbody_tpu_torch import config as C
from nbody_tpu_torch.cli.train import main as train_main


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--num_iters", type=int, default=100000)
    p.add_argument("-b", "--batch_size", type=int, default=10)
    p.add_argument("-n", "--name", type=str, default="TEST")
    p.add_argument("--cells", type=int, default=C.CELLS_PER_SIDE)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--platform", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    fwd = ["--model", "attn", "-l", "0.006",
           "-i", str(args.num_iters), "-b", str(args.batch_size),
           "-n", args.name, "--cells", str(args.cells),
           "--platform", args.platform,
           "-c", *[str(c) for c in C.ATTN_CHANNELS]]
    if args.synthetic:
        fwd.append("--synthetic")
    return train_main(fwd)


if __name__ == "__main__":
    raise SystemExit(main())
