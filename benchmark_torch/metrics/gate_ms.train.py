"""Device milliseconds a train step in the attn layers' channel gates:
the sum of the step timeline's ``.gate`` segments (each layer's three
mean-centred products, the gram, its softmax and the product with xh
plus B, forward and backward; models/attn.py marks them), the mean over
the traced window's samples (yardstick/samples.py).  Nothing where the
program marks no gate segment."""

from benchmark_torch.yardstick import samples


def read(view):
    got = [[v for k, v in s["device_ms"].items() if k.endswith(".gate")]
           for s in samples.window_samples(view)]
    got = [sum(g) for g in got if g]
    return sum(got) / len(got) if got else None
