"""The step's share of the cards' bf16 peak, in %: the model's conv and
head FLOPs a tile (counted by the reference's graph on the cell's
shapes), times the tiles read back in the window, over the window's
seconds and 989 TFLOP/s a card."""

from benchmark.lib.roofline import BF16_FLOPS


def read(run):
    lay = run.layer
    if not lay.get("tiles"):
        return None
    return 100.0 * lay["flops_per_tile"] * lay["tiles"] / lay["window_s"] \
        / (BF16_FLOPS * lay["chips"])
