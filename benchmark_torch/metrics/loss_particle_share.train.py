"""The share of the window's particle-steps that reached the loss, in
percent: the program's ``loss.particles`` counter (batch x particles of
each prediction loss_za takes), summed over the traced window's samples
(yardstick/samples.py), over the window's steps x batch x cells^3.  A
step whose loss covers half its batch reads 50.  Nothing where the
program takes no samples."""

from benchmark_torch.yardstick import samples


def read(view):
    n = samples.counted(view, "loss.particles")
    if n is None:
        return None
    per_step = view.cell.traffic["batch"] * view.cell.config["cells"] ** 3
    return 100.0 * n / (view.units * per_step)
