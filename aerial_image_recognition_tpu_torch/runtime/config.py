"""Typed configuration for the detection pipeline.

A copy of ``aerial_image_recognition_tpu/runtime/config.py``: the keys and
defaults are identical (a test holds them equal), so one config dict drives
either package. Key names mirror the original project's DEFAULT_CONFIG dict
so its users can bring their config dicts across unchanged via
``DetectorConfig.from_dict``; on top of that sit the accelerator-side knobs
(device batch, dtype, prefetch depth).
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class DetectorConfig:
    # --- WMS settings ---
    wms_url: str = "https://service.pdok.nl/hwh/luchtfotorgb/wms/v1_0"
    wms_layer: str = "Actueel_orthoHR"
    wms_srs: str = "EPSG:4326"
    wms_size: Tuple[int, int] = (1280, 1280)
    model_input_size: Tuple[int, int] = (640, 640)
    wms_format: str = "image/jpeg"

    # --- XYZ / WMTS settings ---
    xyz_url: Optional[str] = None
    use_xyz: bool = False
    zoom: int = 21
    wmts_url: Optional[str] = None
    wmts_layer: Optional[str] = None

    # --- Processing settings ---
    tile_size_meters: float = 64.0
    confidence_threshold: float = 0.3
    tile_overlap: float = 0.2
    batch_size: int = 64
    checkpoint_interval: int = 2000
    max_gpu_memory: float = 2.0          # kept for config-dict parity; unused
    duplicate_distance: float = 1.0      # meters; 0 disables dedup
    num_workers: int = 25
    queue_size: int = 64

    # --- Paths ---
    frame_path: str = "amsterdam.shp"
    model_path: str = "yolov7_itcvd"     # model name or checkpoint path
    params_path: Optional[str] = None    # trained-weight checkpoint (.npz)
    output_prefix: str = "detections"

    # --- Model head ---
    model_family: str = "yolov7"         # yolov7 | yolov8 | rtdetr | xunet
    num_classes: int = 1
    max_detections_per_tile: int = 64    # fixed top-K slots per tile
    nms_iou_threshold: float = 0.45

    # --- Accelerator execution ---
    device_batch: int = 64               # per-device batch fed to the step
    dtype: str = "bfloat16"
    mesh_shape: Optional[Tuple[int, ...]] = None
    data_axis: str = "data"
    prefetch_batches: int = 4            # host→device pipeline depth

    # --- Resilience / observability ---
    fetch_timeout: float = 10.0
    fetch_retries: int = 5
    retry_backoff: float = 0.5
    monitor_interval: float = 30.0
    event_log: Optional[str] = None      # JSONL event log path

    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DetectorConfig":
        """Build from a reference-style config dict; unknown keys → .extra."""
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names}
        extra = {k: v for k, v in d.items() if k not in names}
        cfg = cls(**known)
        cfg.extra.update(extra)
        cfg.validate()
        return cfg

    def merged(self, overrides: Optional[Dict[str, Any]]) -> "DetectorConfig":
        """Shallow-merge overrides on top of self."""
        if not overrides:
            return self
        d = self.to_dict()
        d.update(overrides)
        return DetectorConfig.from_dict(d)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def validate(self) -> None:
        if not (0.0 <= self.tile_overlap < 1.0):
            raise ValueError(f"tile_overlap must be in [0,1), got {self.tile_overlap}")
        if not (0.0 <= self.confidence_threshold <= 1.0):
            raise ValueError(f"confidence_threshold must be in [0,1], got {self.confidence_threshold}")
        if self.tile_size_meters <= 0:
            raise ValueError("tile_size_meters must be positive")
        if self.batch_size <= 0 or self.device_batch <= 0:
            raise ValueError("batch sizes must be positive")
        if self.model_family not in ("yolov7", "yolov8", "rtdetr", "xunet"):
            raise ValueError(f"unknown model_family {self.model_family!r}")


DEFAULT_CONFIG: Dict[str, Any] = DetectorConfig().to_dict()
