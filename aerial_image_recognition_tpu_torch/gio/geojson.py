"""GeoJSON read/write for detections, coverage, and checkpoints.

A copy of ``aerial_image_recognition_tpu/gio/geojson.py``.

Output schema mirrors the reference's emissions so QGIS workflows carry
over: detection point FeatureCollections with confidence properties
(simple_detector.py:860-913, _script/utils.py:148-210), coverage polygon
collections (simple_detector.py:901-913), and the self-contained checkpoint
document with features + coverage + metadata.processed_tiles
(simple_detector.py:720-748).
"""

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence


def detections_to_feature_collection(records: Sequence[dict],
                                     metadata: Optional[Dict] = None) -> Dict:
    feats = []
    for r in records:
        props = {"confidence": r["confidence"]}
        if "class" in r:
            props["class"] = r["class"]
        feats.append({
            "type": "Feature",
            "geometry": {"type": "Point",
                         "coordinates": [r["lon"], r["lat"]]},
            "properties": props,
        })
    fc = {"type": "FeatureCollection", "features": feats}
    if metadata:
        fc["metadata"] = metadata
    return fc


def feature_collection_to_detections(fc: Dict) -> List[dict]:
    out = []
    for f in fc.get("features", []):
        if (f.get("geometry") or {}).get("type") != "Point":
            continue
        lon, lat = f["geometry"]["coordinates"][:2]
        rec = {"lon": lon, "lat": lat,
               "confidence": f.get("properties", {}).get("confidence", 1.0)}
        if "class" in f.get("properties", {}):
            rec["class"] = f["properties"]["class"]
        out.append(rec)
    return out


def coverage_to_feature_collection(bboxes: Iterable[Sequence[float]]) -> Dict:
    feats = []
    for b in bboxes:
        w, s, e, n = b
        feats.append({
            "type": "Feature",
            "geometry": {"type": "Polygon", "coordinates": [[
                [w, s], [e, s], [e, n], [w, n], [w, s]]]},
            "properties": {},
        })
    return {"type": "FeatureCollection", "features": feats}


def write_geojson(obj: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=float)   # tolerate numpy scalars
    os.replace(tmp, path)      # atomic — a crash never corrupts outputs


def read_geojson(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def read_polygons(fc_or_path) -> List[List]:
    """FeatureCollection (or path) → list of polygons, each a list of rings
    (numpy-convertible [N,2] lon/lat arrays). Accepts Polygon and
    MultiPolygon features — the format of the reference's AOI frames."""
    import numpy as np
    fc = read_geojson(fc_or_path) if isinstance(fc_or_path, str) else fc_or_path
    polys = []
    feats = fc["features"] if fc.get("type") == "FeatureCollection" else [fc]
    for f in feats:
        g = f.get("geometry", f)
        if not g or not isinstance(g, dict):
            continue                      # null geometry is legal GeoJSON
        if g.get("type") == "Polygon":
            polys.append([np.asarray(r, dtype=np.float64)
                          for r in g["coordinates"]])
        elif g["type"] == "MultiPolygon":
            for p in g["coordinates"]:
                polys.append([np.asarray(r, dtype=np.float64) for r in p])
    return polys
