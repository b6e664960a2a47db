"""Wrapper of the CUDA NMS suppression kernel (``csrc/nms_suppress.cu``).

Replaces the Pallas TPU kernel
``aerial_image_recognition_tpu/ops/pallas_kernels.py:nms_suppress_pallas``.
On a CUDA tensor ``nms_suppress`` launches the kernel on the current stream
or raises; on a CPU tensor it runs the plain version,
``ops/nms._suppress_plain``, which gives the same picks bit for bit. There
is no fallback from the card to the plain version.

What bounds the kernel on the card is the chain of dependent picks, not
bytes or arithmetic. ``batched_nms`` hands the candidates over in priority
order (scores non-increasing and >= −1), and for such rows the kernel
sweeps an alive bitmask chunk by chunk: a warp settles its own 32
candidates with find-first-set and ballots, one barrier ends a chunk, the
later candidates then test their boxes against that chunk's picks alone,
and the steps stop when no candidate is alive (the remaining slots are
filled in one pass). Each thread block votes on its own row; a row that is
not in priority order (or holds a score below −1 or a NaN) takes the
general path of the same kernel, one explicit argmax round per slot. Both
give ``_suppress_plain``'s picks bit for bit.

``nms_suppress.launches`` counts kernel launches (not plain-version calls),
so a run can show that its main path went through the kernel.
"""

import ctypes
import functools

import torch

from aerial_image_recognition_tpu_torch.kernels.args import (
    check_tensor, device_index)

MAX_K = 1024                   # one thread per candidate, one block per image


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry point, built and loaded at the first launch."""
    from aerial_image_recognition_tpu_torch.kernels.build import load
    fn = load("nms_suppress").nms_suppress_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, ctypes.c_float, i, p, p, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def nms_suppress(boxes_t: torch.Tensor, scores: torch.Tensor,
                 classes: torch.Tensor, *, iou_threshold: float = 0.45,
                 max_det: int = 128, class_aware: bool = True):
    """boxes_t [B,4,K] f32 cxcywh, scores [B,K] f32 (−1 below conf),
    classes [B,K] int32 → (idx [B,D] int32, conf [B,D] f32, cls [B,D]
    int32), D = max_det."""
    if boxes_t.device.type == "cpu":
        from aerial_image_recognition_tpu_torch.ops.nms import (
            _suppress_plain)
        return _suppress_plain(boxes_t, scores, classes,
                               iou_threshold=iou_threshold, max_det=max_det,
                               class_aware=class_aware)
    if boxes_t.device.type != "cuda":
        raise ValueError(f"nms_suppress: no kernel for {boxes_t.device}")
    b, four, k = boxes_t.shape
    if four != 4:
        raise ValueError(f"nms_suppress: boxes_t must be [B,4,K], got "
                         f"{tuple(boxes_t.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"nms_suppress: K={k} candidates; the kernel takes "
                         f"1..{MAX_K} (one thread per candidate)")
    dev = boxes_t.device
    for name, t, dtype, shape in (
            ("boxes_t", boxes_t, torch.float32, (b, 4, k)),
            ("scores", scores, torch.float32, (b, k)),
            ("classes", classes, torch.int32, (b, k))):
        check_tensor("nms_suppress", name, t, dtype, shape, dev)
    idx = torch.empty((b, max_det), dtype=torch.int32, device=dev)
    conf = torch.empty((b, max_det), dtype=torch.float32, device=dev)
    cls = torch.empty((b, max_det), dtype=torch.int32, device=dev)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(boxes_t.data_ptr(), scores.data_ptr(), classes.data_ptr(),
             b, k, max_det, float(iou_threshold), int(bool(class_aware)),
             idx.data_ptr(), conf.data_ptr(), cls.data_ptr(),
             device_index(dev), stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: CUDA error "
                           f"{err}")
    nms_suppress.launches += 1
    return idx, conf, cls


nms_suppress.launches = 0
