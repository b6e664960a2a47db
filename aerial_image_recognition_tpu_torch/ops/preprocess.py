"""On-device preprocessing of uint8 tile batches.

Counterpart of the native-size branch of
``aerial_image_recognition_tpu/ops/preprocess.py:preprocess_batch``: uint8
crosses the bus (a quarter of f32's bytes) and the cast and /255 run on the
device. The crop and resize branches arrive with a later slice.
"""

import torch


def preprocess_batch(images: torch.Tensor, *, out_size: int = 640,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 [B,H,W,3] (NHWC) → [B,3,H,W] in ``dtype``, /255.

    The result is the NHWC buffer seen as NCHW, i.e. channels_last memory —
    the layout cuDNN's fast convolutions want — with no copy for the
    relayout itself. Sources other than ``out_size`` raise.
    """
    b, h, w, c = images.shape
    if (h, w) != (out_size, out_size):
        raise NotImplementedError(
            f"tiles of {h}x{w} px need the device resize, which arrives "
            f"with the preprocess slice; this step takes {out_size}-px "
            "tiles only")
    x = images.permute(0, 3, 1, 2)
    return (x.to(torch.float32) / 255.0).to(dtype)
