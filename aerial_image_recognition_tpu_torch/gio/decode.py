"""Central image decode for the ingest and serving planes.

Counterpart of ``aerial_image_recognition_tpu/gio/decode.py:decode_rgb``.
JPEG bytes take the native libjpeg path (``native/fastdecode.cpp`` via
``utils/native.py`` — decodes straight into a numpy buffer, GIL released,
so the fetch thread pools scale across cores); PNG and anything else, or a
machine where the native library does not build, falls back to PIL. The two
paths differ by up to ±2 per channel on JPEGs (their IDCTs differ), so a
scan sees the JAX package's pixels only where both take the same path.
"""

import io
from typing import Optional

import numpy as np

_JPEG_MAGIC = b"\xff\xd8"


def decode_rgb(body: bytes,
               scale_denom: int = 1) -> Optional[np.ndarray]:
    """Image bytes → uint8 [H, W, 3] RGB; None on undecodable input.

    scale_denom ∈ {1,2,4,8}: JPEG-only fractional-DCT downscale during
    decode (cheaper than decode-then-resize for oversized sources)."""
    if not body:
        return None
    if body[:2] == _JPEG_MAGIC:
        from aerial_image_recognition_tpu_torch.utils.native import (
            decode_jpeg_native)
        arr = decode_jpeg_native(body, scale_denom=scale_denom)
        if arr is not None:
            return arr
    from PIL import Image, UnidentifiedImageError
    try:
        img = Image.open(io.BytesIO(body)).convert("RGB")
        if scale_denom > 1:
            img = img.resize((max(1, img.width // scale_denom),
                              max(1, img.height // scale_denom)))
        return np.asarray(img, dtype=np.uint8)
    except (UnidentifiedImageError, OSError, ValueError):
        return None
