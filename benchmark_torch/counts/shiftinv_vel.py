"""Counts of the velocity family (models/shiftinv.py, shiftinv_vel): the
useful FLOPs of a train step, and no neighbor gathers or scatters.

The velocity network is the 4-op network at the velocity widths
(9-32-64-64-32-16-6), so a train step's useful FLOPs are the 4-op
count's (yardstick/flops.py) at those widths, three forward passes, as
nbody_tpu/utils/flops.py counts shiftinv_vel.  The neighbor calls are not
counted here: its cell runs the masked index route, whose 4-op D/E calls
selfcheck.py cannot hold to the program (its route check feeds 6-column
batches), so no gather or scatter roofline reads this family.
"""

from __future__ import annotations

from benchmark_torch.yardstick.flops import forward_flops


def unit_flops(cfg: dict, traffic: dict) -> float:
    """Useful FLOPs of one train step."""
    return 3.0 * forward_flops("shiftinv", cfg["cells"] ** 3, traffic["batch"],
                               cfg["k_neighbors"], cfg["channels"])


def neighbor_calls(cfg: dict, traffic: dict):
    """None: the family's gathers and scatters are not counted."""
    return None
