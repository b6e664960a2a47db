"""SimpleDetector — monolith-API facade (point-grid XYZ city scan).

Counterpart of ``aerial_image_recognition_tpu/pipeline/simple.py``. API
parity with the reference's standalone pipeline (simple_detector.py:26):
``SimpleDetector(model_path, output_dir)`` with ``get_image(lat, lon)``,
``detect_batch(...)``, ``process_batch(points)``, checkpointed ``run(shp)``
over a 60 m point grid. Internally everything routes through the port's
components: XYZFetcher (fixed-window mosaics), the fused detect step on the
card (batched — the reference was stuck at batch=1,
simple_detector.py:648-649), which resizes the fetcher's pixel windows to
the model size on the device, vectorized georef, and grid-bucketed dedup.
"""

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage, XYZFetcher
from aerial_image_recognition_tpu_torch.geo.polygon import polygon_bounds
from aerial_image_recognition_tpu_torch.geo.tiles import generate_point_grid
from aerial_image_recognition_tpu_torch.gio.geojson import read_polygons
from aerial_image_recognition_tpu_torch.gio.shapefile import read_polygons_shp
from aerial_image_recognition_tpu_torch.ingest.pipeline import assemble_batches
from aerial_image_recognition_tpu_torch.pipeline.inference import build_detect_step
from aerial_image_recognition_tpu_torch.post.dedup import dedup_records
from aerial_image_recognition_tpu_torch.post.georef import detections_to_records
from aerial_image_recognition_tpu_torch.post.results import ResultsManager
from aerial_image_recognition_tpu_torch.runtime.checkpoint import (
    grid_fingerprint,
    CheckpointManager, CheckpointState,
)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from aerial_image_recognition_tpu_torch.runtime.device import resolve_device
from aerial_image_recognition_tpu_torch.runtime.observability import PhaseTimer

GOOGLE_XYZ = "http://mt{s}.google.com/vt/lyrs=s&x={x}&y={y}&z={z}"


class SimpleDetector:
    def __init__(self, model_path: str = "yolov7_itcvd",
                 output_dir: str = "output", *,
                 xyz_url: str = GOOGLE_XYZ, zoom: int = 21,
                 confidence_threshold: float = 0.3,
                 device_batch: int = 64, num_workers: int = 25,
                 detect_step=None, fetcher=None, device=None):
        """device: where the step is built when none is injected (default
        ``cuda``; raises here, before anything is fetched, without CUDA)."""
        self._device = (getattr(detect_step, "device", None)
                        if detect_step is not None
                        else resolve_device(device))
        self.zoom = zoom
        self.model_size = 640
        self.confidence_threshold = confidence_threshold
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.config = DetectorConfig(
            model_path=model_path, zoom=zoom, use_xyz=True, xyz_url=xyz_url,
            confidence_threshold=confidence_threshold,
            device_batch=device_batch, num_workers=num_workers)
        self.fetcher = fetcher or XYZFetcher(
            xyz_url, zoom=zoom, num_workers=num_workers,
            subdomains=("0", "1", "2", "3"))
        self._step = detect_step
        self.timers = PhaseTimer()

    # --------------------------------------------------------------- API

    def get_image(self, lat: float, lon: float, target_size_meters: float = 64.0
                  ) -> Optional[Tuple[np.ndarray, Dict, Dict]]:
        """(pixels uint8, preview_info, target_bounds) — monolith get_image
        contract (simple_detector.py:326-453)."""
        tile = self.fetcher.get_image(lat, lon, target_size_meters)
        if tile is None:
            return None
        w, s, e, n = tile.bounds
        bounds = {"west": w, "south": s, "east": e, "north": n}
        preview = {
            "spatial_info": {
                "center": {"lat": lat, "lon": lon},
                "bounds": bounds,
                "zoom_level": self.zoom,
                "meters_per_pixel": tile.meta["meters_per_pixel"],
                "target_size_meters": target_size_meters,
            },
            "image_info": {
                "crop_size": tile.meta["crop_size"],
                "final_size": [tile.meta["crop_size"]] * 2,
            },
            "tiles_stats": {"total_tiles": tile.meta["tiles_total"],
                            "successful_fetches": tile.meta["tiles_ok"]},
        }
        return tile.pixels, preview, bounds

    def _get_step(self, src_size: int):
        if self._step is None or self._step.input_size != src_size:
            self._step = build_detect_step(
                self.config, batch=self.config.device_batch,
                src_size=src_size, device=self._device)
        return self._step

    def detect_batch(self, images: Sequence[np.ndarray],
                     bounds: Sequence[Dict]) -> List[dict]:
        """Batched detection over equally-sized uint8 tiles → detection
        records (lon/lat/confidence dicts, simple_detector.py:648-677
        contract but genuinely batched)."""
        if not images:
            return []
        src = images[0].shape[0]
        step = self._get_step(src)
        tiles = [(i, TileImage(np.ascontiguousarray(img),
                               (b["west"], b["south"], b["east"], b["north"])))
                 for i, (img, b) in enumerate(zip(images, bounds))]
        out: List[dict] = []
        for batch in assemble_batches(iter(tiles), step.batch, src,
                                        layout=step.input_layout):
            det, lon, lat = step(batch.images, batch.bounds)
            recs = detections_to_records(det, batch.bounds,
                                         model_size=step.model_size,
                                         class_names=("car",))
            for r in recs:
                if int(batch.indices[r.pop("tile_index")]) >= 0:
                    out.append(r)
        return out

    def process_batch(self, points: Sequence[Tuple[float, float]],
                      target_size_meters: float = 64.0,
                      window_px: Optional[int] = None):
        """(lat, lon) points → (detections, coverages, timing_stats)
        (simple_detector.py:599-646 contract).

        window_px pins the source pixel window for the whole scan (run()
        passes the AOI-center value) — deriving it per batch from the
        first point's latitude drifts by a pixel across a city, and every
        change would rebuild + recompile the batched detect step."""
        t0 = time.time()
        window = window_px or self.fetcher.window_px(points[0][0],
                                                     target_size_meters)
        tiles = self.fetcher.fetch_batch(
            [(lon - 1e-9, lat - 1e-9, lon + 1e-9, lat + 1e-9)
             for lat, lon in points],
            window_px=window)
        fetch_t = time.time() - t0

        imgs, bnds, covs = [], [], []
        for t in tiles:
            if t is None:
                continue
            w, s, e, n = t.bounds
            imgs.append(t.pixels)
            bnds.append({"west": w, "south": s, "east": e, "north": n})
            covs.append((w, s, e, n))
        t0 = time.time()
        dets = self.detect_batch(imgs, bnds)
        timing = {"tile_fetching": fetch_t, "inference": time.time() - t0}
        return dets, covs, timing

    def _remove_duplicates(self, detections: List[dict],
                           distance_threshold: float = 1.0) -> List[dict]:
        """UTM-metric confidence-greedy dedup
        (simple_detector.py:540-596 semantics, vectorized)."""
        return dedup_records(detections, distance_threshold)

    # --------------------------------------------------------------- run

    def run(self, shp_path: str, spacing_meters: float = 60.0,
            batch_size: int = 100, checkpoint_every: int = 2000,
            duplicate_distance: float = 1.0, force_restart: bool = False
            ) -> Dict:
        """Full point-grid city scan (the monolith __main__,
        simple_detector.py:705-930): 60 m grid → batches → checkpoint every
        2000 tiles → final dedup → results + coverage GeoJSON."""
        with self.timers.phase("grid_creation"):
            polys = (read_polygons(shp_path)
                     if shp_path.endswith((".geojson", ".json"))
                     else read_polygons_shp(shp_path))
            bounds = polygon_bounds([r for p in polys for r in p])
            pts = generate_point_grid(bounds, polys, spacing_meters)
            points = [(float(lat), float(lon)) for lon, lat in pts]

        ckpt = CheckpointManager(self.output_dir, prefix="simple",
                                 style="combined")
        results = ResultsManager(self.output_dir, prefix="simple",
                                 duplicate_distance=duplicate_distance)
        fingerprint = grid_fingerprint(bounds, spacing_meters, 0.0,
                                       len(points))
        # pin one pixel window for the whole scan (see process_batch)
        window = self.fetcher.window_px((bounds[1] + bounds[3]) / 2, 64.0)
        start = 0
        if not force_restart:
            state = ckpt.load()
            if state:
                if (state.grid_fingerprint
                        and state.grid_fingerprint != fingerprint):
                    raise RuntimeError(
                        "checkpoint belongs to a different grid "
                        "(AOI/spacing changed) — pass force_restart=True "
                        "to discard it")
                start = state.processed_count
                results.add(state.detections, state.coverages)

        def active_bbox(next_index):
            # bbox of UNSCANNED points, expanded by the tile half-extent:
            # future detections land inside future tiles, which reach
            # ~32 m beyond their center points (compact()'s soundness
            # argument needs arrivals inside the active bounds)
            rest = points[next_index:]
            if not rest:
                return None
            lats = [p[0] for p in rest]
            lons = [p[1] for p in rest]
            import math
            m_lat = 40.0 / 111319.9
            m_lon = 40.0 / (111319.9 * max(
                0.1, math.cos(math.radians(sum(lats) / len(lats)))))
            return (min(lons) - m_lon, min(lats) - m_lat,
                    max(lons) + m_lon, max(lats) + m_lat)

        def checkpoint(processed):
            # frontier-aware compaction (post/results.compact): bounded
            # memory without the boundary-dependent destruction of a
            # plain periodic dedup
            results.compact(active_bounds=active_bbox(processed))
            ckpt.save(CheckpointState(processed, len(points),
                                      results.detections,
                                      coverages=list(results.coverages),
                                      grid_fingerprint=fingerprint))

        processed = start
        try:
            with self.timers.phase("processing"):
                for i0 in range(start, len(points), batch_size):
                    batch_pts = points[i0:i0 + batch_size]
                    dets, covs, timing = self.process_batch(
                        batch_pts, window_px=window)
                    self.timers.add("tile_fetching", timing["tile_fetching"])
                    self.timers.add("inference", timing["inference"])
                    results.add(dets, covs)
                    processed += len(batch_pts)
                    if processed % checkpoint_every < batch_size:
                        checkpoint(processed)
        except (KeyboardInterrupt, Exception):
            checkpoint(processed)
            raise

        with self.timers.phase("duplicate_removal"):
            results.remove_duplicates()
        with self.timers.phase("saving"):
            out = results.process_results(metadata={
                "grid_points": len(points),
                "phase_timings": self.timers.report()})
        ckpt.clear()
        return {"detections": len(results.detections),
                "points": len(points), "output": out}

    def close(self):
        self.fetcher.close()
