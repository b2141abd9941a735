"""Device idle milliseconds a chunk under the program's checkpoint save:
for each ``saver.save_checkpoint`` range of the program's host spans in
the traced window, its length less the time some device activity ran
within it (the profiler's clock, on which both lie), summed over the
ranges and divided by their number.  Nothing where the program names no
such range."""

from benchmark_torch.yardstick import buckets

SPAN = "saver.save_checkpoint"


def read(view):
    ranges = [(s, e) for name, s, e in view.host_events if name == SPAN]
    if not ranges:
        return None
    stall = 0.0
    for s, e in ranges:
        busy = buckets.union_seconds([(max(a, s), min(b, e))
                                      for _, a, b in view.kernels
                                      if a < e and b > s])
        stall += (e - s) - busy
    return 1e3 * stall / len(ranges)
