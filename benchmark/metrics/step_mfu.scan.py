"""The whole scan's share of the cards' bf16 peak, in %: the family's
FLOPs a tile at the configuration's input size (counted by the
reference's graph after the window), times the tiles of the window's
scans, over the window's seconds and 989 TFLOP/s a card. A share of the
whole step, fetch and host time included: the scan has no kernel
roofline of its own."""

from benchmark.lib.roofline import BF16_FLOPS


def read(run):
    lay = run.layer
    if not lay.get("tiles"):
        return None
    return 100.0 * lay["flops_per_tile"] * lay["tiles"] / lay["window_s"] \
        / (BF16_FLOPS * lay["chips"])
