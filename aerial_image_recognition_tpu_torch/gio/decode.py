"""Image decode for the serving plane.

Counterpart of ``aerial_image_recognition_tpu/gio/decode.py:decode_rgb``,
PIL path only; the native libjpeg path (and its fractional-DCT downscale)
arrives with the ingest slice.
"""

import io
from typing import Optional

import numpy as np


def decode_rgb(body: bytes) -> Optional[np.ndarray]:
    """Image bytes → uint8 [H, W, 3] RGB; None on undecodable input."""
    if not body:
        return None
    from PIL import Image, UnidentifiedImageError
    try:
        img = Image.open(io.BytesIO(body)).convert("RGB")
        return np.asarray(img, dtype=np.uint8)
    except (UnidentifiedImageError, OSError, ValueError):
        return None
