"""Device milliseconds a unit (a train step, or a hop) in PyTorch's own
kernels: every device activity that is neither a GEMM, nor a kernel of
the repository (csrc/*.cu), nor the plans' sort and search
(yardstick/buckets.py).  The unfused elementwise passes, reductions,
copies and the optimizer's update."""

from benchmark_torch.yardstick import buckets


def read(view):
    if not view.kernels or view.units <= 0:
        return None
    total = sum(e - s for _, s, e in view.kernels)
    mine = view.bucket_seconds(buckets.GEMM_BUCKET, buckets.PLAN_BUCKET,
                               *buckets.REPO_BUCKETS)
    return 1e3 * (total - mine) / view.units
