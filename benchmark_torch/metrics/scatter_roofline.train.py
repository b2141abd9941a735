"""The train step's neighbor scatters against their roofline, in percent:
the least time the card could take for them (their logical bytes, each
input row, id and output row of each call counted once, from the
configuration's shapes by the family's counts, at 3.35 TB/s) over the
device time of the kernels that ran them (yardstick/buckets.py: B and D
gather, C and E scatter), a step.  Nothing where the family's counts do
not cover the route or no such kernel ran."""

from benchmark_torch.counts.common import call_bytes
from benchmark_torch.yardstick.peaks import bound

KIND = "scatter"
KERNELS = {"gather": ("B gather", "D/F gather"),
           "scatter": ("C segment sum", "E/G scatter")}[KIND]


def read(view):
    calls = view.neighbor_calls()
    seconds = view.bucket_seconds(*KERNELS)
    if not calls or seconds <= 0 or view.units <= 0:
        return None
    least, _ = bound(sum(call_bytes(c) for c in calls if c.kind == KIND))
    return 100.0 * least / (seconds / view.units)
