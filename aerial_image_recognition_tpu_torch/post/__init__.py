"""post layer of the PyTorch port (see the package docstring).

Re-exports the names of the JAX package's ``post/__init__.py``; its
``lonlat_jax`` is ``lonlat`` here (``post/georef.py``)."""

from aerial_image_recognition_tpu_torch.post.dedup import (  # noqa: F401
    dedup_device, dedup_host, dedup_records, nms_geographic,
)
from aerial_image_recognition_tpu_torch.post.georef import (  # noqa: F401
    detections_to_lonlat, detections_to_records, lonlat,
)
from aerial_image_recognition_tpu_torch.post.results import (  # noqa: F401
    ResultsManager)
from aerial_image_recognition_tpu_torch.post.heatmap import (  # noqa: F401
    hex_heatmap)
