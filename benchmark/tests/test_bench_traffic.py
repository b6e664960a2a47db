"""The traffic generators on the CPU: the copied renderers are pure
functions of the seed and of geography, and the WMS server process
answers GetCapabilities and serves each tile's bytes the same every
time."""

import io
import json
import math

import numpy as np
from PIL import Image

from benchmark.drivers.scan import Server, aoi
from benchmark.lib import registry, tiles

M_PER_DEG = 111319.9


def test_render_tiles_same_seed_same_pixels():
    a, ba = tiles.render_tiles(np.random.default_rng(7), 3, 128)
    b, bb = tiles.render_tiles(np.random.default_rng(7), 3, 128)
    c, _ = tiles.render_tiles(np.random.default_rng(8), 3, 128)
    assert a.tobytes() == b.tobytes() and (ba == bb).all()
    assert a.tobytes() != c.tobytes()
    assert ((a > 200).all(-1).sum((1, 2)) > 0).all()      # cars drawn


def _world(seed):
    return tiles.World(seed, 21.0, 52.2, 2000.0, 530.0)


def test_world_same_seed_same_bytes():
    box = (21.0, 52.2, 21.0 + 320 / (M_PER_DEG * math.cos(math.radians(52.2))),
           52.2 + 320 / M_PER_DEG)
    a = tiles.jpeg(_world(5).render(box, 256, 256), 90)
    b = tiles.jpeg(_world(5).render(box, 256, 256), 90)
    c = tiles.jpeg(_world(6).render(box, 256, 256), 90)
    assert a == b and a != c


def test_overlapping_tiles_agree():
    """Two tiles that overlap by half, on one pixel grid, show the same
    ground and the same cars in the overlap."""
    w = _world(11)
    px = 512
    deg_x = 400 / (M_PER_DEG * math.cos(math.radians(52.2)))
    deg_y = 400 / M_PER_DEG
    west, south = 20.998, 52.198
    left = w.render((west, south, west + deg_x, south + deg_y), px, px)
    shift = deg_x / 2
    right = w.render((west + shift, south, west + shift + deg_x,
                      south + deg_y), px, px)
    a, b = left[:, px // 2:], right[:, :px // 2]
    assert (a == b).all(-1).mean() > 0.999
    cars_a, cars_b = (a > 200).all(-1), (b > 200).all(-1)
    assert cars_a.sum() > 50
    assert (cars_a == cars_b).mean() > 0.999


def test_server_process():
    t = registry.load_traffic("scan-1280")
    server = Server({"seed": 3, "lon0": t["lon0"], "lat0": t["lat0"],
                     "extent_m": 3000.0, "cars_per_km2": 530.0,
                     "jpeg_quality": 90, "render_workers": 2})
    try:
        caps = server.get("/wms?SERVICE=WMS&REQUEST=GetCapabilities")
        assert b"<Name>aerial</Name>" in caps and b"EPSG:4326" in caps
        w, s, _, _ = aoi(dict(t, grid=2))
        box = (w, s, w + 0.004, s + 0.003)
        one = server.tile(box, 256)
        assert server.tile(box, 256) == one
        img = np.asarray(Image.open(io.BytesIO(one)))
        assert img.shape == (256, 256, 3)
        assert one == tiles.jpeg(tiles.World(3, t["lon0"], t["lat0"], 3000.0,
                                             530.0).render(box, 256, 256), 90)
        served = json.loads(server.get("/served"))
        assert served["renders"] == 1 and served["requests"] == 2
        assert np.allclose(served["bboxes"][0], box)
    finally:
        server.close()
    assert server.proc.poll() is not None
