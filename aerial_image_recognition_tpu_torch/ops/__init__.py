"""ops layer of the PyTorch port (see the package docstring).

Re-exports the names of the JAX package's ``ops/__init__.py``."""

from aerial_image_recognition_tpu_torch.ops.decode import (  # noqa: F401
    decode_yolov7, decode_yolov8)
from aerial_image_recognition_tpu_torch.ops.nms import (  # noqa: F401
    Detections, batched_nms, iou_matrix)
from aerial_image_recognition_tpu_torch.ops.preprocess import (  # noqa: F401
    assemble_mosaic, preprocess_batch)
