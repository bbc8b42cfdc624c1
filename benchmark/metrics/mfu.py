"""``mfu.<cells>``: the whole step's share of the chip's bf16 peak: model
FLOPs of the work completed in the window (``flops.py``, from the
configuration and each input's real size; a training step three forwards)
over the window's seconds times the peak, in percent."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(ctx, window, trace):
    if window["seconds"] <= 0 or window["flops"] <= 0:
        return None
    return 100.0 * window["flops"] / (window["seconds"] * PEAK_BF16_FLOPS)
