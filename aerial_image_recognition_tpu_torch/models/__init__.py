"""models layer of the PyTorch port (see the package docstring).

Re-exports the names of the JAX package's ``models/__init__.py``."""

from aerial_image_recognition_tpu_torch.models.registry import (  # noqa: F401
    REGISTRY, ModelBundle, ModelSpec, create_model, load_params,
    resolve_model_name, save_params,
)
from aerial_image_recognition_tpu_torch.models.yolov7 import (  # noqa: F401
    YOLOv7)
from aerial_image_recognition_tpu_torch.models.yolov8 import (  # noqa: F401
    YOLOv8)
from aerial_image_recognition_tpu_torch.models.xunet import (  # noqa: F401
    XUnet)
