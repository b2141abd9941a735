"""Device milliseconds a train step in the masked route's block layout
work: the sum of the step timeline's ``.layout`` segments (block_patches,
patches_fold, edges_cube_to_blocks and nodes_blocks_to_cube, forward and
backward; ops/blocked.py marks them), the mean over the traced window's
samples (yardstick/samples.py).  Nothing where the program marks no
layout segment."""

from benchmark_torch.yardstick import samples


def read(view):
    got = [[v for k, v in s["device_ms"].items() if k.endswith(".layout")]
           for s in samples.window_samples(view)]
    got = [sum(g) for g in got if g]
    return sum(got) / len(got) if got else None
