"""A WMTS-fed city scan through the port's ``CarDetector`` against the JAX
package's, each over its own fake server and its own f32 step (the trained
fixture, 768-px neighbourhood mosaics resized on the step to 128 px by the
bilinear matrix resize). The same tiles, records (count and classes equal,
lon/lat within 1e-6°, confidence within 1e-5) and coverage layer.
"""

import os

import numpy as np
import torch

from aerial_image_recognition_tpu.fetch import fake as JF
from aerial_image_recognition_tpu.fetch.wmts import WMTSFetcher as JWMTS
from aerial_image_recognition_tpu.pipeline.detector import (
    CarDetector as JaxCarDetector)
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.fetch import fake as PF
from aerial_image_recognition_tpu_torch.fetch.wmts import WMTSFetcher
from aerial_image_recognition_tpu_torch.gio.geojson import (
    read_geojson, write_geojson)
from aerial_image_recognition_tpu_torch.pipeline.detector import CarDetector
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")
CFG = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.05,
           nms_preselect="exact", quad_stem=False)
WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.002, n_cars=40,
             seed=9)
AOI = {"type": "FeatureCollection", "features": [{
    "type": "Feature", "properties": {},
    "geometry": {"type": "Polygon", "coordinates": [[
        [20.9992, 52.1992], [21.0008, 52.1992], [21.0008, 52.2008],
        [20.9992, 52.2008], [20.9992, 52.1992]]]}}]}

torch.set_num_threads(2)


def _scan(base, fake, fetcher_cls, detector_cls, step):
    srv = fake.FakeTileServer(fake.FakeWorld(**WORLD))
    srv.start()
    try:
        os.makedirs(base, exist_ok=True)
        frame = os.path.join(base, "aoi.geojson")
        write_geojson(AOI, frame)
        fetcher = fetcher_cls(srv.base_url + "/wmts", layer="fake",
                              matrix_set="FAKE2180", crs=2180, num_workers=8)
        det = detector_cls(base, {
            "frame_path": frame, "wmts_url": srv.base_url + "/wmts",
            "wmts_layer": "fake", "tile_size_meters": 128.0,
            "batch_size": 8, "device_batch": 4, "duplicate_distance": 1.0,
            "checkpoint_interval": 10**9, "confidence_threshold": 0.05},
            fetcher=fetcher, detect_step=step)
        out = det.detect(force_restart=True)
        fetcher.close()
    finally:
        srv.stop()
    doc = read_geojson(os.path.join(base, "output",
                                    "detections_results.geojson"))
    cov = read_geojson(os.path.join(base, "output",
                                    "detections_coverage.geojson"))
    recs = sorted((f["geometry"]["coordinates"][0],
                   f["geometry"]["coordinates"][1],
                   f["properties"]["confidence"], f["properties"]["class"])
                  for f in doc["features"])
    return out, recs, cov


def test_wmts_scan_equals_jax_scan(tmp_path):
    kw = dict(batch=4, src_size=768, model_size=128)
    out_j, recs_j, cov_j = _scan(
        str(tmp_path / "jax"), JF, JWMTS, JaxCarDetector,
        jax_build_detect_step(JaxDetectorConfig.from_dict(CFG), **kw))
    out_p, recs_p, cov_p = _scan(
        str(tmp_path / "port"), PF, WMTSFetcher, CarDetector,
        build_detect_step(DetectorConfig.from_dict(CFG), device="cpu", **kw))
    assert out_p["tiles"] == out_j["tiles"] >= 2
    assert cov_p == cov_j
    assert len(recs_p) == len(recs_j) > 0
    assert [r[3] for r in recs_p] == [r[3] for r in recs_j]
    a = np.asarray([r[:3] for r in recs_p])
    b = np.asarray([r[:3] for r in recs_j])
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-6, rtol=0)
    np.testing.assert_allclose(a[:, 2], b[:, 2], atol=1e-5, rtol=0)
