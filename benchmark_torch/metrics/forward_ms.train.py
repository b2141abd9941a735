"""Device milliseconds a train step from the step's start to the loss: the kNN search, the route's plan, the features, every layer's forward and the loss.  Read from the timeline the
program samples of each traced chunk's last step (on the card, CUDA
events captured into the step's graph; yardstick/samples.py), the mean
over the window's chunks.  Nothing where the program takes no samples."""

from benchmark_torch.yardstick import samples


def read(view):
    return samples.mean_phase_ms(view, "forward")
