"""aerial_image_recognition_tpu_torch — the PyTorch/CUDA port of the
aerial car-detection framework, for NVIDIA Hopper (H100).

It stands beside ``aerial_image_recognition_tpu`` (the JAX/TPU package,
which stays the reference) and imports nothing from it: module names mirror
the reference's so each counterpart is easy to find. Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas is a hand-written CUDA
kernel here (``csrc/``), built with nvcc at first use (``kernels/build.py``).

The package covers the fused detect step (with its accuracy modes and
turnkey int8) and the detection server, for every detector family the
reference registers (YOLOv7-tiny and -base, the YOLOv8 n–x ladder):
  runtime   config (a copy of the reference's keys and defaults), device choice
  models    npz weight reader + flax→torch bridge, upstream .pt/.onnx
            importers, YOLOv7 tiny/base, YOLOv8 n–x, registry, int8 trunks
  ops       preprocess, CLAHE/TTA, decode, batched NMS (+ the CUDA
            suppression, CLAHE and int8 epilogue kernels)
  kernels   nvcc build of ``csrc/*.cu`` into ctypes libraries
  post      georeferencing (device lon/lat, host f64 records)
  pipeline  build_detect_step / DetectStep, DetectionServer
  gio       image decode (PIL)

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without an explicit device it raises.
"""

__version__ = "0.1.0"

from aerial_image_recognition_tpu_torch.runtime.config import (  # noqa: F401
    DEFAULT_CONFIG, DetectorConfig)

__all__ = ["DetectorConfig", "DEFAULT_CONFIG", "__version__"]
