"""pipeline layer of the PyTorch port (see the package docstring)."""

from aerial_image_recognition_tpu_torch.pipeline.detector import (  # noqa: F401
    CarDetector)
from aerial_image_recognition_tpu_torch.pipeline.simple import (  # noqa: F401
    SimpleDetector)
from aerial_image_recognition_tpu_torch.pipeline.inference import (  # noqa: F401
    DetectStep, build_detect_step, make_detect_fn, make_segment_fn,
)
