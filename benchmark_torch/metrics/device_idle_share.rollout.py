"""The share of the traced window in which no operation ran on the card,
in percent: 100 * (1 - busy / window), busy the union of the device
activities' intervals, the window on the host clock."""


def read(view):
    if view.window_s <= 0 or not view.kernels:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
