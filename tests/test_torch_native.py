"""The port's native host helpers (its copies of native/fastgeo.cpp and
native/fastdecode.cpp, built by ``utils/native.py`` into ``build/native``)
against their numpy / PIL paths and the JAX package's helpers.

g++ and libjpeg are on this machine, so the native paths must actually
run here (``native_paths``); every comparison is at tolerance 0, on inputs
made from seeds with numpy.
"""

import io

import numpy as np
import pytest
from PIL import Image

from aerial_image_recognition_tpu.gio.decode import decode_rgb as jax_decode
from aerial_image_recognition_tpu.post.dedup import (
    dedup_host as jax_dedup_host, dedup_records as jax_dedup_records)
from aerial_image_recognition_tpu.utils.native import (
    decode_jpeg_native as jax_decode_native)
from aerial_image_recognition_tpu_torch.fetch.fake import (
    FakeTileServer, FakeWorld)
from aerial_image_recognition_tpu_torch.geo.polygon import points_in_rings
from aerial_image_recognition_tpu_torch.gio.decode import decode_rgb
from aerial_image_recognition_tpu_torch.post.dedup import (
    dedup_host, dedup_records, nms_geographic)
from aerial_image_recognition_tpu_torch.utils import native
from aerial_image_recognition_tpu_torch.utils.native import (
    decode_jpeg_native, dedup_grid_native, native_paths,
    points_in_rings_native)


def _jpeg(arr, quality=92):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_native_libraries_build_into_build_dir():
    assert native_paths() == {"fastgeo": True, "fastdecode": True,
                              "fastpack": True}
    built = sorted(p.name for p in native.BUILD_DIR.glob("lib*.so"))
    assert any(n.startswith("libfastgeo-") for n in built)
    assert any(n.startswith("libfastdecode-") for n in built)
    assert any(n.startswith("libfastpack-") for n in built)
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    # nothing is built beside the port's sources
    assert not list(native._SRC_DIR.glob("*.so"))


@pytest.mark.parametrize("n,radius,spread", [(3000, 2.0, 0.01),
                                             (800, 1.0, 0.001),
                                             (5000, 5.0, 0.02),
                                             (400, 0.5, 0.0005)])
def test_native_dedup_equals_numpy_and_jax(n, radius, spread):
    rng = np.random.default_rng(n)
    lon = 21.0 + rng.random(n) * spread
    lat = 52.2 + rng.random(n) * spread
    conf = rng.random(n).astype(np.float32)
    conf[: n // 10] = conf[n // 10: 2 * (n // 10)]      # exact ties
    got = dedup_host(lon, lat, conf, radius, use_native=True)
    np.testing.assert_array_equal(
        got, dedup_host(lon, lat, conf, radius, use_native=False))
    np.testing.assert_array_equal(got, jax_dedup_host(lon, lat, conf,
                                                      radius))
    assert 0 < got.sum() < n


def test_dedup_records_and_nms_geographic_equal_jax():
    rng = np.random.default_rng(9)
    recs = [{"lon": 21.0 + x * 1e-4, "lat": 52.2 + y * 1e-4,
             "confidence": float(c), "class": "car"}
            for x, y, c in rng.random((600, 3))]
    assert dedup_records(recs, 1.5) == jax_dedup_records(recs, 1.5)
    assert nms_geographic(recs) == jax_dedup_records(recs, 2.0)
    assert dedup_records(recs, 0.0) == recs and dedup_records([], 1.0) == []
    # the reference rule: 0.5 m apart → the weaker goes; 5 m apart stays
    m = 1.0 / (111319.9 * np.cos(np.radians(52.2)))
    three = [{"lon": 21.0, "lat": 52.2, "confidence": 0.9},
             {"lon": 21.0 + 0.5 * m, "lat": 52.2, "confidence": 0.8},
             {"lon": 21.0 + 5.0 * m, "lat": 52.2, "confidence": 0.7}]
    assert [r["confidence"] for r in dedup_records(three, 1.0)] == [0.9, 0.7]


def test_native_dedup_validates_lengths():
    with pytest.raises(ValueError, match="lengths"):
        dedup_grid_native(np.zeros(3), np.zeros(3), np.zeros(2), 1.0)


def test_native_points_in_rings_equals_numpy():
    rng = np.random.default_rng(4)
    outer = np.array([[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]], float)
    hole = np.array([[4, 4], [6, 4], [6, 6], [4, 6], [4, 4]], float)
    pts = rng.random((2000, 2)) * 12 - 1
    np.testing.assert_array_equal(points_in_rings_native(pts, [outer, hole]),
                                  points_in_rings(pts, [outer, hole]))


@pytest.mark.parametrize("shape,quality,denom", [
    ((96, 128, 3), 92, 1), ((640, 640, 3), 88, 1), ((128, 128, 3), 75, 2),
    ((128, 128, 3), 95, 4), ((64, 48, 3), 50, 8)])
def test_native_decode_equals_jax_bit_for_bit(shape, quality, denom):
    rng = np.random.default_rng(shape[0] + denom)
    body = _jpeg(rng.integers(0, 255, shape, dtype=np.uint8), quality)
    got = decode_jpeg_native(body, scale_denom=denom)
    assert got is not None
    assert got.shape == (shape[0] // denom, shape[1] // denom, 3)
    np.testing.assert_array_equal(got, jax_decode_native(body,
                                                         scale_denom=denom))
    np.testing.assert_array_equal(decode_rgb(body, scale_denom=denom), got)
    if denom == 1:
        pil = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        assert np.abs(got.astype(int) - pil.astype(int)).max() <= 2


def test_decode_of_fake_server_jpegs_equals_jax():
    """FakeTileServer's JPEGs (quality 88, the scan's input) decode to the
    same pixels in both packages."""
    srv = FakeTileServer(FakeWorld(n_cars=40, seed=2, extent_deg=0.004))
    for bbox in [(20.999, 52.199, 21.0, 52.2), (21.0, 52.2, 21.001, 52.201)]:
        for size in (96, 640):
            body = srv._jpeg(srv.world.render(bbox, size, size))
            np.testing.assert_array_equal(decode_rgb(body), jax_decode(body))


def test_decode_png_fallback_and_garbage():
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    np.testing.assert_array_equal(decode_rgb(buf.getvalue()), arr)
    half = decode_rgb(buf.getvalue(), scale_denom=2)
    np.testing.assert_array_equal(half, jax_decode(buf.getvalue(),
                                                   scale_denom=2))
    assert decode_jpeg_native(b"\xff\xd8\x00garbage" * 10) is None
    assert decode_rgb(b"\xff\xd8\x00garbage" * 10) is None
    assert decode_rgb(b"") is None and decode_rgb(b"no image") is None


def test_without_a_compiler_the_numpy_paths_run(monkeypatch, tmp_path):
    """No g++: the loaders return None and the callers fall back, as the
    reference's contract says (utils/native.py)."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setenv("PATH", str(tmp_path))          # no g++ on it
    assert native_paths() == {"fastgeo": False, "fastdecode": False,
                              "fastpack": False}
    rng = np.random.default_rng(2)
    lon = 21.0 + rng.random(300) * 0.001
    lat = 52.2 + rng.random(300) * 0.001
    conf = rng.random(300)
    np.testing.assert_array_equal(dedup_host(lon, lat, conf, 1.0),
                                  jax_dedup_host(lon, lat, conf, 1.0))
    body = _jpeg(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
    pil = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    np.testing.assert_array_equal(decode_rgb(body), pil)
    # the quad stem's host relayout takes its numpy copies
    from aerial_image_recognition_tpu_torch.ops.quadstem import (
        host_s2d2, host_s2d2_into)
    px = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    out = np.zeros((4, 4, 48), np.uint8)
    assert not native.pack_quad_native(px, out)
    host_s2d2_into(px, out)
    np.testing.assert_array_equal(out, host_s2d2(px))
