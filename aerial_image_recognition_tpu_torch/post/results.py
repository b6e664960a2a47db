"""Results accumulation + final emission.

A copy of ``aerial_image_recognition_tpu/post/results.py``.

ResultsManager parity (_script/utils.py:148-292): accumulate detection
records, periodic dedup (confidence-greedy metric NMS — post.dedup), write
``{prefix}_results.geojson`` plus intermediate saves, with run metadata
embedded in the output document (simple_detector.py:872-913 embeds timings,
dedup params, UTM zone). Adds shapefile emission for QGIS parity.
"""

import os
import time
from typing import Dict, List, Optional, Sequence

from aerial_image_recognition_tpu_torch.gio.geojson import (
    coverage_to_feature_collection, detections_to_feature_collection,
    write_geojson,
)
from aerial_image_recognition_tpu_torch.gio.shapefile import detections_to_shapefile
from aerial_image_recognition_tpu_torch.post.dedup import dedup_records
from aerial_image_recognition_tpu_torch.geo.tmerc import utm_epsg


def _proximity_components(x, y, radius: float):
    """Connected components of the ≤radius proximity graph over points in
    local meters → int label per point. Grid-bucketed union-find, O(n·k)
    like the dedup itself."""
    import numpy as np

    n = len(x)
    parent = np.arange(n)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    cell = {}
    cx = np.floor(x / max(radius, 1e-9)).astype(np.int64)
    cy = np.floor(y / max(radius, 1e-9)).astype(np.int64)
    for i in range(n):
        cell.setdefault((cx[i], cy[i]), []).append(i)
    r2 = radius * radius
    for i in range(n):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for j in cell.get((cx[i] + dx, cy[i] + dy), ()):
                    if j <= i:
                        continue
                    if (x[i] - x[j]) ** 2 + (y[i] - y[j]) ** 2 <= r2:
                        ri, rj = find(i), find(j)
                        if ri != rj:
                            parent[rj] = ri
    return np.array([find(i) for i in range(n)])


class ResultsManager:
    def __init__(self, output_dir: str, prefix: str = "detections",
                 duplicate_distance: float = 1.0,
                 write_shapefile: bool = True,
                 heatmap_hex_m: float = 0.0):
        self.output_dir = output_dir
        self.prefix = prefix
        self.duplicate_distance = duplicate_distance
        self.write_shp = write_shapefile
        self.heatmap_hex_m = heatmap_hex_m
        self.detections: List[dict] = []
        self.coverages: List = []
        os.makedirs(output_dir, exist_ok=True)

    def add(self, records: Sequence[dict],
            coverages: Optional[Sequence] = None):
        self.detections.extend(records)
        if coverages:
            self.coverages.extend(coverages)

    def remove_duplicates(self) -> int:
        """In-place dedup; returns number removed."""
        before = len(self.detections)
        self.detections = dedup_records(self.detections,
                                        self.duplicate_distance)
        return before - len(self.detections)

    def compact(self, active_bounds=None) -> int:
        """Bounded-memory periodic dedup that cannot change the final set.

        Plain remove_duplicates() at arbitrary checkpoints is destructive in
        a boundary-dependent way: a record suppressed NOW can lose its
        suppressor LATER (a higher-confidence duplicate arriving from an
        overlapping neighbor tile suppresses the suppressor, which should
        resurrect the record) — so where the periodic dedups happen changes
        the final output, and an interrupted+resumed scan differs from an
        uninterrupted one. compact() destroys a suppressed record only when
        its influence neighborhood is final: farther than a safety margin
        from ``active_bounds`` (bbox of tiles not yet scanned). Suppressed
        records near the scan frontier are retained (a few tile rows at
        most), so memory stays bounded while the final global dedup is
        boundary-independent. (The reference's periodic dedup at
        _script/detector.py:209-219 has the boundary-dependent semantics;
        this is the deterministic upgrade.)
        """
        if not self.detections or self.duplicate_distance <= 0:
            return 0
        import numpy as np

        from aerial_image_recognition_tpu_torch.post.dedup import dedup_host

        lon = np.array([r["lon"] for r in self.detections])
        lat = np.array([r["lat"] for r in self.detections])
        conf = np.array([r["confidence"] for r in self.detections])
        keep = dedup_host(lon, lat, conf, self.duplicate_distance)
        if active_bounds is None:
            retained = keep
        else:
            # Soundness via the proximity graph: future arrivals land
            # INSIDE active_bounds, can directly touch only records within
            # one radius of it, and suppression/resurrection cascades only
            # propagate along ≤radius links — i.e. within a connected
            # component. A component with no member within one radius of
            # the active bbox is therefore final (even a future record
            # bridging two components sits inside the bbox, so both
            # bridged components already count as near). Suppressed
            # records are destroyed only in final components — this holds
            # for arbitrarily long suppression chains, unlike a fixed
            # distance margin.
            w, s, e, n = active_bounds
            r = self.duplicate_distance
            # components in the SAME UTM frame dedup_host measures in —
            # an approximate metric could disagree about threshold-distance
            # links and misclassify a component as final
            from aerial_image_recognition_tpu_torch.post.dedup import _to_utm
            x, y = _to_utm(lon, lat)
            comp = _proximity_components(x, y, r)
            bx, by = _to_utm(np.array([lon[0], w, e, w, e]),
                             np.array([lat[0], s, s, n, n]))
            near = ((x >= bx[1:].min() - r) & (x <= bx[1:].max() + r)
                    & (y >= by[1:].min() - r) & (y <= by[1:].max() + r))
            marked = np.zeros(comp.max() + 1, dtype=bool)
            marked[comp[near]] = True
            retained = keep | marked[comp]
        before = len(self.detections)
        self.detections = [r for r, k in zip(self.detections, retained) if k]
        return before - len(self.detections)

    def save_intermediate(self, tag: str = "intermediate") -> str:
        path = os.path.join(self.output_dir, f"{self.prefix}_{tag}.geojson")
        write_geojson(detections_to_feature_collection(self.detections), path)
        return path

    def process_results(self, metadata: Optional[Dict] = None) -> str:
        """Final dedup + write {prefix}_results.geojson (+ .shp). Returns
        the geojson path."""
        removed = self.remove_duplicates()
        meta = {
            "generated": time.time(),
            "count": len(self.detections),
            "duplicates_removed": removed,
            "duplicate_distance_m": self.duplicate_distance,
        }
        if self.detections:
            meta["utm_epsg"] = utm_epsg(self.detections[0]["lon"],
                                        self.detections[0]["lat"])
        if metadata:
            meta.update(metadata)
        path = os.path.join(self.output_dir, f"{self.prefix}_results.geojson")
        write_geojson(detections_to_feature_collection(self.detections, meta),
                      path)
        if self.coverages:
            cov = (coverage_to_feature_collection(self.coverages)
                   if not isinstance(self.coverages[0], dict)
                   else {"type": "FeatureCollection",
                         "features": list(self.coverages)})
            write_geojson(cov, os.path.join(
                self.output_dir, f"{self.prefix}_coverage.geojson"))
        if self.write_shp and self.detections:
            detections_to_shapefile(
                os.path.join(self.output_dir, f"{self.prefix}_results.shp"),
                self.detections)
        if self.heatmap_hex_m > 0 and self.detections:
            from aerial_image_recognition_tpu_torch.post.heatmap import hex_heatmap
            hex_heatmap(self.detections, self.heatmap_hex_m,
                        output_geojson=os.path.join(
                            self.output_dir,
                            f"{self.prefix}_hex_heatmap.geojson"))
        return path
