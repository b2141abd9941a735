"""Device milliseconds a train step in the attn layers' batch norms: the
sum of the step timeline's ``.norm`` segments (each hidden layer's leaky
relu, batch statistics and affine, forward and backward; models/attn.py
marks them), the mean over the traced window's samples
(yardstick/samples.py).  Nothing where the program marks no norm
segment."""

from benchmark_torch.yardstick import samples


def read(view):
    got = [[v for k, v in s["device_ms"].items() if k.endswith(".norm")]
           for s in samples.window_samples(view)]
    got = [sum(g) for g in got if g]
    return sum(got) / len(got) if got else None
