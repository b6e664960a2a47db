"""runtime layer of the PyTorch port (see the package docstring).

Re-exports the names of the JAX package's ``runtime/__init__.py``."""

from aerial_image_recognition_tpu_torch.runtime.config import (
    DEFAULT_CONFIG, DetectorConfig)

__all__ = ["DetectorConfig", "DEFAULT_CONFIG"]
