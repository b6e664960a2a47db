"""aerial_image_recognition_tpu_torch — the PyTorch/CUDA port of the
aerial car-detection framework, for NVIDIA Hopper (H100).

It stands beside ``aerial_image_recognition_tpu`` (the JAX/TPU package,
which stays the reference) and imports nothing from it: module names mirror
the reference's so each counterpart is easy to find. Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas is a hand-written CUDA
kernel here (``csrc/``), built with nvcc at first use (``kernels/build.py``).

The package covers the city scan end to end, its front ends and the
detection server, for every detector family the reference registers
(YOLOv7-tiny and -base, the YOLOv8 n–x ladder). Layer map (bottom-up):
  geo       geodesy and tiling math (web mercator, transverse mercator/UTM,
            slippy tiles, metric tile grids), numpy
  gio       geospatial IO: image decode, GeoJSON, ESRI shapefile, GeoTIFF,
            GeoPackage (pure Python)
  models    npz weight reader/writer + flax→torch bridge, upstream .pt/.onnx
            importers and the .onnx export, YOLOv7 tiny/base, YOLOv8 n–x,
            registry, int8 trunks
  ops       preprocess, CLAHE/TTA, decode, batched NMS (+ the CUDA
            suppression, CLAHE and int8 epilogue kernels)
  kernels   nvcc build of ``csrc/*.cu`` into ctypes libraries
  fetch     WMS/XYZ/WMTS tile acquisition with retries, an asyncio facade,
            a fake tile server
  ingest    host batches and the pinned upload ring feeding the card
  post      georeferencing (device lon/lat, host f64 records), dedup
            (host grid; the fixed-slot device scan), results, heatmap
  parallel  meshes of devices (data parallelism over tiles), AOI stripes
            and the halo-exchange dedup, torch.distributed processes
  runtime   config, device choice, checkpoints, observability, doctor
  pipeline  build_detect_step / DetectStep, CarDetector, SimpleDetector,
            the GeoTIFF and image-file workflows, the resolution sweep,
            DetectionServer, and the CLI (``python -m
            aerial_image_recognition_tpu_torch``)

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the CLI); without CUDA and without an explicit device
it raises.
"""

__version__ = "0.1.0"

from aerial_image_recognition_tpu_torch.runtime.config import (  # noqa: F401
    DEFAULT_CONFIG, DetectorConfig)

__all__ = ["DetectorConfig", "DEFAULT_CONFIG", "__version__"]
from aerial_image_recognition_tpu_torch.pipeline.detector import (  # noqa: E402,F401
    CarDetector)
from aerial_image_recognition_tpu_torch.pipeline.simple import (  # noqa: E402,F401
    SimpleDetector)
from aerial_image_recognition_tpu_torch.pipeline.inference import (  # noqa: E402,F401
    DetectStep, build_detect_step, make_detect_fn,
)
from aerial_image_recognition_tpu_torch.gio.geojson import (  # noqa: E402,F401
    detections_to_feature_collection, feature_collection_to_detections,
    coverage_to_feature_collection, read_geojson, read_polygons,
    write_geojson,
)
from aerial_image_recognition_tpu_torch.gio.shapefile import (  # noqa: E402,F401
    ShapeRecord, detections_to_shapefile, read_dbf, read_polygons_shp,
    read_shapefile, write_shapefile,
)
from aerial_image_recognition_tpu_torch.gio.geotiff import (  # noqa: E402,F401
    GeoTiff, read_geotiff, write_geotiff,
)
