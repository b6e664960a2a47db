"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W;
the copy of chip_smoke.py:303-306) and the operations and bytes of the
kernels whose roofline share the benchmark reports."""

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12            # outside the tensor cores
BF16_FLOPS = 989e12          # tensor cores, dense


def nms_bound_s(b: int, k: int, d: int, rounds: int) -> float:
    """Least time of one ``nms_suppress`` launch over b rows of k
    candidates into d slots, whose inputs need ``rounds`` picks in all
    (the copy of chip_smoke.py:579-585): per candidate once its
    half-extents, corners and area (9 flops), per round and candidate the
    pick, the IoU with it and the test (15); the inputs read once (boxes
    4k, scores k, classes k, 4 bytes each) and the three outputs written
    once (d each)."""
    flops = b * 9 * k + rounds * 15 * k
    nbytes = 4 * (b * 4 * k + b * k + b * k) + 3 * b * d * 4
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_S)
