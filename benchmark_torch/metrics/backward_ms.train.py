"""Device milliseconds a train step from the loss to the end of loss.backward(): every layer's backward.  Read from the timeline the
program samples of each traced chunk's last step (on the card, CUDA
events captured into the step's graph; yardstick/samples.py), the mean
over the window's chunks.  Nothing where the program takes no samples."""

from benchmark_torch.yardstick import samples


def read(view):
    return samples.mean_phase_ms(view, "backward")
