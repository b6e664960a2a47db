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

# The rest of the top-level names are imported on first use (PEP 562): a
# process that needs one light module, such as the fetch workers'
# forkserver (``fetch/workers.py``), does not import torch with the package.
_LAZY = {
    "CarDetector": "pipeline.detector",
    "SimpleDetector": "pipeline.simple",
    "DetectStep": "pipeline.inference",
    "build_detect_step": "pipeline.inference",
    "make_detect_fn": "pipeline.inference",
    "detections_to_feature_collection": "gio.geojson",
    "feature_collection_to_detections": "gio.geojson",
    "coverage_to_feature_collection": "gio.geojson",
    "read_geojson": "gio.geojson",
    "read_polygons": "gio.geojson",
    "write_geojson": "gio.geojson",
    "ShapeRecord": "gio.shapefile",
    "detections_to_shapefile": "gio.shapefile",
    "read_dbf": "gio.shapefile",
    "read_polygons_shp": "gio.shapefile",
    "read_shapefile": "gio.shapefile",
    "write_shapefile": "gio.shapefile",
    "GeoTiff": "gio.geotiff",
    "read_geotiff": "gio.geotiff",
    "write_geotiff": "gio.geotiff",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
