"""The deformable-attention sampling kernel's (``csrc/ms_deform_attn.cu``)
share of its roofline, in %: the least time of one launch at the shapes of
the program's last launch (``ops/ms_deform_attn.ms_deform_attn.last_shape``,
which the wrapper keeps) over its device time a launch in the traced scan.

The least time is the larger of its bytes over 3.35 TB/s of HBM and its
operations over 67 TFLOP/s of f32 (``bound_s``). None where the program
has no such kernel or the trace holds no launch of it."""

from benchmark.lib.roofline import F32_FLOPS, HBM_BYTES_S


def bound_s(shape: dict) -> float:
    """Least time of one launch: the value map, the locations, the weights
    and the output each read or written once (f32); per sample and channel
    the bilinear blend of four corners and the weighted add (9 flops), per
    sample its coordinates and corner weights (14)."""
    b, heads, d = shape["batch"], shape["heads"], shape["head_dim"]
    q, points = shape["queries"], shape["points"]
    samples = b * q * heads * len(shape["levels"]) * points
    nbytes = 4 * (b * shape["tokens"] * heads * d + 3 * samples
                  + b * q * heads * d)
    flops = samples * (9 * d + 14)
    return max(nbytes / HBM_BYTES_S, flops / F32_FLOPS)


def last_shape():
    """The shapes of the program's last launch, or None."""
    try:
        from aerial_image_recognition_tpu_torch.ops.ms_deform_attn import (
            ms_deform_attn)
    except ImportError:
        return None
    return getattr(ms_deform_attn, "last_shape", None)


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernel_count("ms_deform_attn")
    device_s = run.trace.kernel_s("ms_deform_attn")
    shape = last_shape()
    if not launches or device_s <= 0 or shape is None:
        return None
    return 100.0 * bound_s(shape) / (device_s / launches)
