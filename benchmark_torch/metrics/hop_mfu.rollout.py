"""A whole hop's share of the card's bf16 dense peak, in percent: the
useful FLOPs of a hop's forward pass (yardstick/flops.py, through the
family's counts) times the hops the traced window completed, over the
window's time, over 989 TFLOP/s."""

from benchmark_torch.yardstick.peaks import H100_BF16_TC_OPS


def read(view):
    if view.window_s <= 0 or view.units <= 0:
        return None
    return 100.0 * view.unit_flops() * view.units / view.window_s / H100_BF16_TC_OPS
