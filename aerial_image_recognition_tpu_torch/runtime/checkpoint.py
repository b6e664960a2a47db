"""Resumable checkpointing for city scans.

A copy of ``aerial_image_recognition_tpu/runtime/checkpoint.py``: the files
it writes are the JAX package's, so either package resumes the other's scan.

Supports both reference checkpoint generations (SURVEY.md §5):
  * split state (modular CheckpointManager, _script/utils.py:68-146):
    ``processing_state.json`` {processed_count, total_tiles, timestamp} +
    ``latest_detections.geojson``
  * self-contained GeoJSON (monolith, simple_detector.py:720-748):
    features + coverage + metadata.processed_tiles in one document

Resume granularity is the deterministic tile index — tiles are a pure
function of (AOI, tile_size, overlap), so skipping the first N is exact.
All writes are atomic (tmp + rename): an interrupt mid-save never corrupts
the previous checkpoint.
"""

import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

from aerial_image_recognition_tpu_torch.gio.geojson import (
    detections_to_feature_collection, feature_collection_to_detections,
    read_geojson, write_geojson,
)


@dataclass
class CheckpointState:
    processed_count: int
    total_tiles: int
    detections: List[dict]
    coverages: List[dict] = field(default_factory=list)
    timestamp: float = 0.0
    grid_fingerprint: Optional[str] = None


class CheckpointManager:
    def __init__(self, checkpoint_dir: str, prefix: str = "",
                 style: str = "split"):
        self.checkpoint_dir = checkpoint_dir
        self.prefix = (prefix + "_") if prefix else ""
        self.style = style
        os.makedirs(checkpoint_dir, exist_ok=True)

    # paths -----------------------------------------------------------
    @property
    def state_path(self) -> str:
        return os.path.join(self.checkpoint_dir,
                            f"{self.prefix}processing_state.json")

    @property
    def detections_path(self) -> str:
        return os.path.join(self.checkpoint_dir,
                            f"{self.prefix}latest_detections.geojson")

    @property
    def combined_path(self) -> str:
        return os.path.join(self.checkpoint_dir,
                            f"{self.prefix}checkpoint.geojson")

    # ops --------------------------------------------------------------
    def save(self, state: CheckpointState) -> None:
        state.timestamp = time.time()
        if self.style == "combined":
            doc = detections_to_feature_collection(state.detections)
            doc["coverage"] = state.coverages
            doc["metadata"] = {
                "processed_tiles": state.processed_count,
                "total_tiles": state.total_tiles,
                "timestamp": state.timestamp,
                "grid_fingerprint": state.grid_fingerprint,
            }
            write_geojson(doc, self.combined_path)
            return
        meta = {"processed_count": state.processed_count,
                "total_tiles": state.total_tiles,
                "timestamp": state.timestamp,
                "grid_fingerprint": state.grid_fingerprint}
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        write_geojson(detections_to_feature_collection(state.detections),
                      self.detections_path)
        os.replace(tmp, self.state_path)   # state last → detections never newer

    def load(self) -> Optional[CheckpointState]:
        if self.style == "combined":
            if not os.path.exists(self.combined_path):
                return None
            doc = read_geojson(self.combined_path)
            meta = doc.get("metadata", {})
            return CheckpointState(
                processed_count=meta.get("processed_tiles", 0),
                total_tiles=meta.get("total_tiles", 0),
                detections=feature_collection_to_detections(doc),
                coverages=doc.get("coverage", []),
                timestamp=meta.get("timestamp", 0.0),
                grid_fingerprint=meta.get("grid_fingerprint"))
        if not os.path.exists(self.state_path):
            return None
        with open(self.state_path) as f:
            meta = json.load(f)
        dets: List[dict] = []
        if os.path.exists(self.detections_path):
            dets = feature_collection_to_detections(
                read_geojson(self.detections_path))
        return CheckpointState(
            processed_count=meta.get("processed_count", 0),
            total_tiles=meta.get("total_tiles", 0),
            detections=dets,
            timestamp=meta.get("timestamp", 0.0),
            grid_fingerprint=meta.get("grid_fingerprint"))

    def clear(self) -> None:
        for p in (self.state_path, self.detections_path, self.combined_path):
            if os.path.exists(p):
                os.remove(p)


def grid_fingerprint(bounds, tile_size_m: float, overlap: float,
                     n_tiles: int) -> str:
    """Cheap identity of the deterministic grid — a resume against a changed
    AOI/config is refused rather than silently misaligned."""
    return (f"{bounds[0]:.8f},{bounds[1]:.8f},{bounds[2]:.8f},{bounds[3]:.8f}"
            f"|{tile_size_m}|{overlap}|{n_tiles}")
