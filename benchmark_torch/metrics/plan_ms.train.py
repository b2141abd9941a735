"""Device milliseconds a train step in the plans' sort and search
kernels (the graph plan of the direct route, the block plan of the index
route, the reverse-edge lookup's plan): the "sort + search" bucket of
yardstick/buckets.py.  Nothing where no such kernel ran."""

from benchmark_torch.yardstick import buckets


def read(view):
    if view.units <= 0:
        return None
    s = view.bucket_seconds(buckets.PLAN_BUCKET)
    return 1e3 * s / view.units if s > 0 else None
