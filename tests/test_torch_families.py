"""The other detector families in the port — YOLOv7-base and the YOLOv8 n–x
ladder (yolov8_tokyo = YOLOv8l, nc=2) — against the JAX package.

f32 on the CPU. yolov8n runs the trained fixture ``yolov8n_fakeworld.npz``
on 96-px FakeWorld tiles at its training scale (0.1 m/px); yolov7-base runs
a flax init (``PRNGKey(0)``, 64 px) bridged to the port, and random
upstream-named weights through the port's importers. Inputs come from
seeds with numpy. Tolerances, each stated where it is used:

* raw head maps: atol/rtol 1e-4 (f32 convolutions summed in another order);
* ``decode_yolov8``: boxes atol 1e-3 px, scores atol 1e-6 (an elementwise
  sum over the 16 bins where the reference writes an einsum);
* the detect step against the JAX step, with ``quad_stem: false`` and
  with the default quad stem on both sides: valid slots and classes
  identical, boxes within 1e-3 px, scores within 1e-5, lon/lat within
  1e-6°;
* upstream imports: trees bit-equal to the JAX package's; raw maps within
  2e-4 of the largest magnitude of the upstream interpreter's, as
  tests/test_arch_differential.py holds the JAX package.
"""

import io
import json
import math
import os
import sys
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aerial_image_recognition_tpu.fetch.fake import FakeTileServer, FakeWorld
from aerial_image_recognition_tpu.gio.geojson import read_geojson, write_geojson
from aerial_image_recognition_tpu.models import import_torch as JI
from aerial_image_recognition_tpu.models.onnx_lite import (
    load_onnx_initializers as jax_load_onnx)
from aerial_image_recognition_tpu.models.registry import (
    REGISTRY as JAX_REGISTRY, ModelBundle as JaxBundle,
    load_params as jax_load_params, resolve_model_name as jax_resolve,
    save_params as jax_save_params)
from aerial_image_recognition_tpu.models.torch_pt import (
    load_checkpoint_state as jax_load_checkpoint)
from aerial_image_recognition_tpu.models.upstream_spec import (
    YOLOV7_BASE_SPEC, YOLOV7_TINY_SPEC, make_state_dict, run_spec_torch,
    yolov8_spec)
from aerial_image_recognition_tpu.ops.decode import (
    decode_yolov8 as jax_decode_yolov8)
from aerial_image_recognition_tpu.pipeline.detector import CarDetector
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.fetch.fake import (
    FakeTileServer as PortFakeTileServer, FakeWorld as PortFakeWorld)
from aerial_image_recognition_tpu_torch.models import import_torch as PI
from aerial_image_recognition_tpu_torch.models.layers import fold_batchnorm
from aerial_image_recognition_tpu_torch.models.onnx_lite import (
    load_onnx_initializers, write_minimal_onnx)
from aerial_image_recognition_tpu_torch.models.registry import (
    REGISTRY, create_model, resolve_model_name)
from aerial_image_recognition_tpu_torch.models.torch_pt import (
    _StubUnpickler, load_checkpoint_state)
from aerial_image_recognition_tpu_torch.models.weights import (
    load_flax_into, params_from_flax, params_to_flax)
from aerial_image_recognition_tpu_torch.models.yolov7 import YOLOv7
from aerial_image_recognition_tpu_torch.models.yolov8 import YOLOv8
from aerial_image_recognition_tpu_torch.ops.decode import decode_yolov8
from aerial_image_recognition_tpu_torch.pipeline.detector import (
    CarDetector as PortCarDetector)
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step, detection_sets_agree)
from aerial_image_recognition_tpu_torch.pipeline.serve import DetectionServer
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
V8_FIXTURE = os.path.join(FIXTURES, "yolov8n_fakeworld.npz")
V8_SIZE = 96                 # 9.6 m tiles at the fixture's 0.1 m/px
M2LON = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
M2LAT = 1.0 / 111319.9

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_bundle(name, params):
    """A JAX ModelBundle without the 640-px init create_model would run."""
    spec = JAX_REGISTRY[name]
    return JaxBundle(spec=spec, module=spec.make_module(dtype=jnp.float32),
                     params=params)


def _family(bundle, x):
    """The JAX bundle's raw maps and decoded (boxes, scores) of x, jitted
    once (eager flax dispatch is slower than the compile here)."""
    raw = jax.jit(lambda p, x: bundle.raw_apply(p, x))(bundle.params,
                                                        jnp.asarray(x))
    return [np.array(o) for o in raw]


def _port_module(name, tree, fold=False):
    module = REGISTRY[name].make_module().eval()
    load_flax_into(module, tree)
    if fold:
        fold_batchnorm(module)
    return module.requires_grad_(False)


def v8_tiles(n_car=8, n_empty=8, seed=4):
    """96-px FakeWorld tiles at 0.1 m/px: n_car centred on a car, then up
    to n_empty with no car near (tests/test_v8_detection_quality.py's
    sampling). Returns (uint8 [n,96,96,3], bounds [n,4], centred flags)."""
    world = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                      n_cars=400, seed=seed)
    half = 4.8
    imgs, bounds, centred = [], [], []
    for lon, lat, _ in world.cars[:n_car]:
        bb = (lon - half * M2LON, lat - half * M2LAT,
              lon + half * M2LON, lat + half * M2LAT)
        imgs.append(world.render(bb, V8_SIZE, V8_SIZE))
        bounds.append(bb)
        centred.append(True)
    rng = np.random.default_rng(0)
    for lon, lat in zip(world.center_lon + (rng.random(64) - 0.5) * 0.009,
                        world.center_lat + (rng.random(64) - 0.5) * 0.009):
        if sum(not c for c in centred) == n_empty:
            break
        bb = (lon - half * M2LON, lat - half * M2LAT,
              lon + half * M2LON, lat + half * M2LAT)
        if any(bb[0] - 3 * M2LON < c[0] < bb[2] + 3 * M2LON
               and bb[1] - 3 * M2LAT < c[1] < bb[3] + 3 * M2LAT
               for c in world.cars):
            continue
        imgs.append(world.render(bb, V8_SIZE, V8_SIZE))
        bounds.append(bb)
        centred.append(False)
    return np.stack(imgs), np.asarray(bounds, np.float32), centred


@pytest.fixture(scope="module")
def images():
    return v8_tiles()


@pytest.fixture(scope="module")
def v8n(images):
    """The trained nano, and the JAX raw maps of 4 of the tiles (/255)."""
    tree = _np_tree(jax_load_params(V8_FIXTURE))
    jb = _jax_bundle("yolov8n", jax.tree_util.tree_map(jnp.asarray, tree))
    x = images[0][:4].astype(np.float32) / 255.0
    return dict(tree=tree, jb=jb, x=x, raw=_family(jb, x))


@pytest.fixture(scope="module")
def v7b(images):
    """yolov7-base: a flax init (PRNGKey(0); jitted, which gives the eager
    init's values), as numpy, and the JAX raw maps of 4 64-px crops."""
    module = JAX_REGISTRY["yolov7_base"].make_module(dtype=jnp.float32)
    x = np.ascontiguousarray(images[0][:4, :64, :64]).astype(
        np.float32) / 255.0

    def init_and_apply(key, x):           # one compile for both
        v = module.init(key, jnp.zeros((1, 32, 32, 3)), train=False)
        return v, module.apply(v, x, train=False)

    tree, raw = jax.jit(init_and_apply)(jax.random.PRNGKey(0), x)
    tree = _np_tree(tree)
    jb = _jax_bundle("yolov7_base", jax.tree_util.tree_map(jnp.asarray,
                                                            tree))
    return dict(tree=tree, jb=jb, x=x, raw=[np.array(o) for o in raw])


# ------------------------------------------------------- shapes and names

@pytest.mark.parametrize("name", ["yolov8n", "yolov8s", "yolov8m",
                                  "yolov8l", "yolov8x", "yolov7_base"])
def test_state_dict_shapes_equal_flax_init(name):
    """Every leaf of the flax init (by jax.eval_shape, no forward) has its
    tensor in the port's module, of the bridged shape, and nothing else."""
    module = JAX_REGISTRY[name].make_module(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in params_from_flax(tree).items()}
    port = REGISTRY[name].make_module()
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want


def test_registry_matches_the_reference():
    """Every model the reference registers (the detectors and the
    segmentation model), with its family, classes and input size; names
    resolve as there. The port registers one model more, RT-DETR-R50
    (``tests/test_torch_rtdetr.py``), which the reference has not."""
    assert set(REGISTRY) == set(JAX_REGISTRY) | {"rtdetr_r50vd"}
    for name in JAX_REGISTRY:
        spec, ref = REGISTRY[name], JAX_REGISTRY[name]
        assert (spec.family, spec.num_classes, spec.input_size,
                spec.class_names) == (ref.family, ref.num_classes,
                                      ref.input_size, ref.class_names)
    for path in ("yolov8n.onnx", "models/YOLOv8x.onnx", "yolov8_tokyo",
                 "yolov8_tokyo_checkpoint.pt", "tokyo.onnx", "yolov8.onnx",
                 "yolov7_base", "car_aerial_detection_yolo7_ITCVD_deepness"
                 ".onnx", "itcvd", "yolov7-w6.onnx", "xunet_256",
                 "ramp_XUnet_256.onnx"):
        assert resolve_model_name(path) == jax_resolve(path), path
    for path in ("resnet.onnx", "detr"):
        with pytest.raises(KeyError):
            resolve_model_name(path)
    assert isinstance(REGISTRY["yolov8_tokyo"].make_module(), YOLOv8) \
        and REGISTRY["yolov8_tokyo"].make_module().scale == "l"


def test_random_v8_gets_the_prior_bias():
    bundle = create_model("yolov8n", seed=3, dtype=torch.float32,
                          device="cpu")
    for i in range(3):
        assert torch.all(getattr(bundle.module.detect,
                                 f"cls{i}_out").bias == -5.0)
    box = bundle.module.detect.box0_out.bias
    assert not torch.all(box == -5.0)
    assert bundle.supports_s2d2()
    # the six output convs stay f32 under a bf16 trunk
    bf = create_model("yolov8n", dtype=torch.bfloat16, device="cpu",
                      fold_bn=True)
    assert {h.weight.dtype for h in bf.module.heads()} == {torch.float32}
    assert bf.module.detect.box0_cv1.conv.weight.dtype == torch.bfloat16


def test_weight_bridge_new_leaf_kinds(v7b, v8n):
    """The BN-less RepConv conv bias and the nested yolov8 scopes map both
    ways, leaf for leaf."""
    sd = params_from_flax(v7b["tree"])
    np.testing.assert_array_equal(
        sd["rep3.conv.bias"].numpy(),
        v7b["tree"]["params"]["rep3"]["conv"]["bias"])
    sd8 = params_from_flax(v8n["tree"])
    node = v8n["tree"]["params"]["detect"]["box0_out"]
    np.testing.assert_array_equal(sd8["detect.box0_out.weight"].numpy(),
                                  node["kernel"][0, 0].T)
    np.testing.assert_array_equal(
        sd8["c2f1.m0.cv1.bn.running_var"].numpy(),
        v8n["tree"]["batch_stats"]["c2f1"]["m0"]["cv1"]["bn"]["var"])
    for name, tree in (("yolov7_base", v7b["tree"]),
                       ("yolov8n", v8n["tree"])):
        back = params_to_flax(_port_module(name, tree))
        flat_a = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        flat_b = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert flat_a.keys() == flat_b.keys()
        for k, v in flat_b.items():
            np.testing.assert_array_equal(flat_a[k], v, err_msg=str(k))


# ------------------------------------------------------------ raw maps

@pytest.mark.parametrize("form", ["plain", "folded"])
@pytest.mark.parametrize("family", ["yolov8n", "yolov7_base"])
def test_raw_maps_match_flax(v8n, v7b, family, form):
    pair = v8n if family == "yolov8n" else v7b
    module = _port_module(family, pair["tree"], fold=form == "folded")
    with torch.no_grad():
        got = module(torch.from_numpy(pair["x"]).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, pair["raw"]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_decode_yolov8_matches_jax(v8n):
    rng = np.random.default_rng(6)
    random = [rng.normal(0, 2, (2, s, s, 66)).astype(np.float32)
              for s in (8, 4, 2)]
    for outs in (random, v8n["raw"]):
        wb, ws = jax_decode_yolov8([jnp.asarray(o) for o in outs], 2)
        gb, gs = decode_yolov8([torch.from_numpy(o) for o in outs], 2)
        assert tuple(gb.shape) == wb.shape and tuple(gs.shape) == ws.shape
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-3,
                                   rtol=0)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6,
                                   rtol=0)


def test_bundle_forward_matches_jax(v8n):
    x = v8n["x"]
    wb, ws = (np.asarray(a) for a in jax.jit(v8n["jb"].forward)(
        v8n["jb"].params, jnp.asarray(x)))
    bundle = create_model("yolov8n", params_path=V8_FIXTURE,
                          dtype=torch.float32, device="cpu", fold_bn=True)
    with torch.no_grad():
        gb, gs = bundle.forward(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(gb.numpy(), wb, atol=1e-3, rtol=0)
    np.testing.assert_allclose(gs.numpy(), ws, atol=1e-5, rtol=0)


def test_trained_v8n_finds_cars(images):
    """tests/test_v8_detection_quality.py through the port: a car on >= 7
    of 8 centred tiles, its box centre within 15 px of mid-tile, nothing on
    the empty tiles."""
    from aerial_image_recognition_tpu_torch.ops.nms import batched_nms
    tiles, _, centred = images
    assert sum(not c for c in centred) >= 4
    bundle = create_model("yolov8n", params_path=V8_FIXTURE,
                          dtype=torch.float32, device="cpu", fold_bn=True)
    with torch.no_grad():
        boxes, scores = bundle.forward(
            torch.from_numpy(tiles).float().permute(0, 3, 1, 2) / 255.0)
    det = batched_nms(boxes, scores, num_classes=2, conf_threshold=0.3,
                      iou_threshold=0.45, max_det=16)
    n = det.valid.sum(1).numpy()
    hit = 0
    for i, is_car in enumerate(centred):
        if not is_car:
            assert n[i] == 0, f"false positives on empty tile {i}: {n[i]}"
            continue
        hit += n[i] >= 1
        if n[i]:
            j = int(det.scores[i].argmax())
            cx, cy = det.boxes[i, j, :2].tolist()
            assert abs(cx - 48) < 15 and abs(cy - 48) < 15, (cx, cy)
    assert hit >= 7


# --------------------------------------------------------- the detect step

def _v7b_step_params(tmp_path_factory):
    """Upstream-named random weights (seed 13) through the port's importer,
    detect kernels ×30 so that scores spread over (0, 1) and no two of a
    tile's candidates lie within float error of each other; saved as a
    reference-format npz both packages load."""
    sd = make_state_dict(YOLOV7_BASE_SPEC, nc=1, seed=13)
    tree = PI.variables_from_torch_state(sd, "yolov7_base")
    for i in range(3):
        tree["params"][f"detect{i}"]["kernel"] = \
            tree["params"][f"detect{i}"]["kernel"] * np.float32(30.0)
    path = str(tmp_path_factory.mktemp("v7b") / "yolov7_base.npz")
    jax_save_params(tree, path)
    return path


def _step_inputs(family):
    if family == "yolov8n":
        tiles, bounds, _ = v8_tiles(n_car=6, n_empty=2)
        return tiles, bounds
    rng = np.random.default_rng(21)
    tiles = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    bounds = np.asarray([(21.0 + k * 1e-3, 52.2, 21.0005 + k * 1e-3,
                          52.2005) for k in range(4)], np.float32)
    return tiles, bounds


def _step_cfg(family, path, **extra):
    return dict(dtype="float32", model_path=family, params_path=path,
                confidence_threshold=0.3 if family == "yolov8n" else 0.6,
                nms_preselect="exact", **extra)


@pytest.mark.parametrize("family", ["yolov8n", "yolov7_base"])
def test_detect_step_matches_jax_step(family, tmp_path_factory):
    path = V8_FIXTURE if family == "yolov8n" \
        else _v7b_step_params(tmp_path_factory)
    tiles, bounds = _step_inputs(family)
    size = tiles.shape[1]
    cfg = _step_cfg(family, path, quad_stem=False)
    kw = dict(batch=len(tiles), src_size=size, model_size=size)
    jax_step = jax_build_detect_step(JaxDetectorConfig.from_dict(cfg), **kw)
    assert jax_step.input_layout == "hwc"
    port_step = build_detect_step(DetectorConfig.from_dict(cfg),
                                  device="cpu", **kw)
    jdet, jlon, jlat = jax_step(tiles, bounds)
    pdet, plon, plat = port_step(tiles, bounds)
    valid = np.asarray(jdet.valid)
    assert valid.sum() >= len(tiles) - 2
    np.testing.assert_array_equal(pdet.valid.numpy(), valid)
    np.testing.assert_array_equal(pdet.classes.numpy(),
                                  np.asarray(jdet.classes))
    np.testing.assert_allclose(pdet.boxes.numpy(), np.asarray(jdet.boxes),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(pdet.scores.numpy(), np.asarray(jdet.scores),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(plon.numpy()[valid], np.asarray(jlon)[valid],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(plat.numpy()[valid], np.asarray(jlat)[valid],
                               atol=1e-6, rtol=0)
    if family == "yolov8n":
        # the FakeWorld cars are class 0 (car) in the trained fixture
        assert set(pdet.classes.numpy()[valid].tolist()) == {0}


def test_detect_step_against_jax_default_quad_path():
    """Both defaults send native-size yolov8 tiles through the quad stem
    (BN and /255 folded into the stem convs): every detection matched at
    IoU 0.5, boxes within 1e-3 px, scores within 1e-5, lon/lat within
    1e-6°."""
    tiles, bounds = _step_inputs("yolov8n")
    cfg = _step_cfg("yolov8n", V8_FIXTURE)
    kw = dict(batch=len(tiles), src_size=V8_SIZE, model_size=V8_SIZE)
    jax_step = jax_build_detect_step(JaxDetectorConfig.from_dict(cfg), **kw)
    assert jax_step.input_layout == "s2d2"
    port_step = build_detect_step(DetectorConfig.from_dict(cfg),
                                  device="cpu", **kw)
    assert port_step.input_layout == "s2d2"
    jout = jax_step(tiles, bounds)
    pout = port_step(tiles, bounds)
    ok, stats = detection_sets_agree(pout, jout)
    n = int(np.asarray(jout[0].valid).sum())
    assert ok and stats["matched"] == stats["total_a"] == n >= 6, stats
    valid = np.asarray(jout[0].valid)
    np.testing.assert_array_equal(pout[0].valid.numpy(), valid)
    np.testing.assert_allclose(pout[0].boxes.numpy()[valid],
                               np.asarray(jout[0].boxes)[valid], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(pout[0].scores.numpy()[valid],
                               np.asarray(jout[0].scores)[valid], atol=1e-5,
                               rtol=0)
    for p, j in zip(pout[1:], jout[1:]):
        np.testing.assert_allclose(p.numpy()[valid], np.asarray(j)[valid],
                                   atol=1e-6, rtol=0)


def _scan(base, server, step, detector=CarDetector):
    aoi = {"type": "FeatureCollection", "features": [{
        "type": "Feature", "properties": {},
        "geometry": {"type": "Polygon", "coordinates": [[
            [20.9997, 52.1998], [21.0003, 52.1998], [21.0003, 52.2002],
            [20.9997, 52.2002], [20.9997, 52.1998]]]}}]}
    frame = os.path.join(base, "aoi.geojson")
    os.makedirs(base, exist_ok=True)
    write_geojson(aoi, frame)
    det = detector(base, {
        "frame_path": frame, "use_xyz": False,
        "wms_url": server.base_url + "/wms", "wms_layer": "fake",
        "wms_size": (V8_SIZE, V8_SIZE), "tile_size_meters": 9.6,
        "tile_overlap": 0.2, "model_path": "yolov8n",
        "batch_size": 16, "device_batch": 8, "num_workers": 8,
        "duplicate_distance": 1.0, "checkpoint_interval": 10**9,
        "confidence_threshold": 0.3, "submit_spacing": 0.0},
        detect_step=step)
    out = det.detect(force_restart=True)
    doc = read_geojson(os.path.join(base, "output",
                                    "detections_results.geojson"))
    return out, sorted(
        (f["geometry"]["coordinates"][0], f["geometry"]["coordinates"][1],
         f["properties"]["confidence"], f["properties"].get("class"))
        for f in doc["features"])


def test_city_scan_with_port_v8n_step_matches_jax_step(tmp_path):
    """A FakeWorld city scan (WMS, 9.6 m tiles of 96 px) by the port's
    CarDetector over the port's fake server with the port's yolov8n step
    gives the JAX CarDetector's records with the JAX step."""
    world = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.0006,
                 n_cars=40, seed=3)
    cfg = _step_cfg("yolov8n", V8_FIXTURE, quad_stem=False)
    kw = dict(batch=8, src_size=V8_SIZE, model_size=V8_SIZE)
    jax_step = jax_build_detect_step(JaxDetectorConfig.from_dict(cfg), **kw)
    port_step = build_detect_step(DetectorConfig.from_dict(cfg),
                                  device="cpu", **kw)
    srv = FakeTileServer(FakeWorld(**world))
    psrv = PortFakeTileServer(PortFakeWorld(**world))
    srv.start()
    psrv.start()
    try:
        out_j, recs_j = _scan(str(tmp_path / "jax"), srv, jax_step)
        out_p, recs_p = _scan(str(tmp_path / "port"), psrv, port_step,
                              detector=PortCarDetector)
    finally:
        srv.stop()
        psrv.stop()
    assert out_p["tiles"] == out_j["tiles"] > 20
    assert len(recs_p) == len(recs_j) >= 5
    assert [r[3] for r in recs_p] == [r[3] for r in recs_j]
    a = np.asarray([r[:3] for r in recs_p])
    b = np.asarray([r[:3] for r in recs_j])
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-6, rtol=0)
    np.testing.assert_allclose(a[:, 2], b[:, 2], atol=1e-5, rtol=0)


def test_server_names_the_classes(images):
    """A DetectionServer over a yolov8n step answers PNG /detect requests;
    each record carries its class name from spec.class_names."""
    tiles, bounds, centred = images
    step = build_detect_step(DetectorConfig.from_dict(_step_cfg(
        "yolov8n", V8_FIXTURE)), batch=4, model_size=V8_SIZE,
        src_size=V8_SIZE, device="cpu")
    assert step.bundle.spec.class_names == ("car", "truck")
    srv = DetectionServer(detect_step=step, max_wait_ms=20.0).start()
    try:
        classes = []
        for k in (0, 1, 2):
            buf = io.BytesIO()
            Image.fromarray(tiles[k]).save(buf, "PNG")
            w, s, e, n = (float(v) for v in bounds[k])
            req = urllib.request.Request(
                f"{srv.url}/detect?west={w!r}&south={s!r}&east={e!r}"
                f"&north={n!r}", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.load(r)
            assert r.status == 200 and body["count"] == len(
                body["detections"]) >= 1
            classes += [d["class"] for d in body["detections"]]
        with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] == 3
    finally:
        srv.stop()
    assert classes and set(classes) <= {"car", "truck"}


# ----------------------------------------- upstream weights, .onnx and .pt

UPSTREAM = [("yolov7_itcvd", "yolov7_tiny", 1), ("yolov7_base",
                                                 "yolov7_base", 1),
            ("yolov8n", "yolov8", 2), ("yolov8m", "yolov8", 2)]


def _upstream_spec(model):
    if model == "yolov7_itcvd":
        return YOLOV7_TINY_SPEC
    if model == "yolov7_base":
        return YOLOV7_BASE_SPEC
    return yolov8_spec(model[-1])


def _assert_maps_match_spec(module, spec, sd, nc, family, seed=1):
    x = np.random.default_rng(seed).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    want = run_spec_torch(spec, sd, x, nc=nc, family=family)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.transpose(w, (0, 2, 3, 1))
        assert tuple(g.shape) == w.shape
        err = float(np.max(np.abs(g.numpy() - w)) / (np.max(np.abs(w))
                                                     + 1e-6))
        assert err < 2e-4, err


@pytest.mark.parametrize("model,family,nc", UPSTREAM,
                         ids=[u[0] for u in UPSTREAM])
def test_upstream_import_into_port_modules(model, family, nc):
    """Random upstream-named state dicts (the JAX package's upstream_spec)
    through the port's importer: the tree is bit-equal to the JAX
    package's, and the port's module on it reproduces the upstream graph's
    raw maps (the independent torch interpreter)."""
    spec = _upstream_spec(model)
    sd = make_state_dict(spec, nc=nc, seed=7)
    tree = PI.variables_from_torch_state(sd, model)
    ref = JI.variables_from_torch_state(sd, model)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_b.items():
        assert flat_a[k].dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(flat_a[k], np.asarray(v),
                                      err_msg=str(k))
    _assert_maps_match_spec(_port_module(model, tree), spec, sd, nc, family)
    # the public entry builds the same model from the tree (BN folded)
    bundle = create_model(model, variables=tree, dtype=torch.float32,
                          device="cpu", fold_bn=True)
    assert bundle.variables is tree
    _assert_maps_match_spec(bundle.module, spec, sd, nc, family)


def test_importer_tables_equal_the_reference():
    assert PI.yolov7_tiny_mapping() == JI.yolov7_tiny_mapping()
    assert PI.yolov7_base_mapping() == JI.yolov7_base_mapping()
    for scale in "nsmlx":
        assert PI.yolov8_n_c2f(scale) == JI.yolov8_n_c2f(scale)
        assert PI.yolov8_mapping(PI.yolov8_n_c2f(scale)) == \
            JI.yolov8_mapping(JI.yolov8_n_c2f(scale))
    rng = np.random.default_rng(0)
    w = rng.normal(size=(18, 128, 1, 1)).astype(np.float32)
    b = rng.normal(size=(18,)).astype(np.float32)
    ia = rng.normal(size=(1, 128, 1, 1)).astype(np.float32)
    im = rng.normal(size=(1, 18, 1, 1)).astype(np.float32)
    for got, want in zip(PI.fold_idetect(w, b, ia, im),
                         JI.fold_idetect(w, b, ia, im)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError, match="missing"):
        PI.import_torch_state({}, PI.yolov7_tiny_mapping())
    tree = PI.variables_from_torch_state(
        make_state_dict(YOLOV7_TINY_SPEC, nc=1, seed=2), "yolov7_itcvd")
    sd = PI.export_torch_state(tree, PI.yolov7_tiny_mapping())
    back = PI.import_torch_state(sd, PI.yolov7_tiny_mapping())
    assert back["params"]["elan1"]["cv1"]["conv"]["kernel"].tobytes() == \
        tree["params"]["elan1"]["cv1"]["conv"]["kernel"].tobytes()


def test_onnx_lite_round_trip_and_drill(tmp_path):
    """tests/test_onnx_lite.py's round trip, then the weight-drop drill
    into the port: a synthetic upstream-named yolov8n .onnx, read by the
    port's reader (equal to the JAX package's), imported, loaded into the
    port's module, matching the upstream interpreter."""
    rng = np.random.default_rng(1)
    tensors = {
        "model.0.conv.weight": rng.normal(size=(32, 12, 3, 3)).astype(
            np.float32),
        "model.77.m.0.bias": rng.normal(size=(18,)).astype(np.float32),
        "some.int64": np.arange(7, dtype=np.int64),
        "scalarish": np.asarray([3.5], np.float32),
    }
    p = str(tmp_path / "m.onnx")
    write_minimal_onnx(p, tensors)
    back = load_onnx_initializers(p)
    assert set(back) == set(tensors)
    for k in tensors:
        assert back[k].dtype == tensors[k].dtype
        np.testing.assert_array_equal(back[k], tensors[k])
    spec = yolov8_spec("n")
    sd = make_state_dict(spec, nc=2, seed=3)
    blob = str(tmp_path / "yolov8n.onnx")
    write_minimal_onnx(blob, sd)
    got, want = load_onnx_initializers(blob), jax_load_onnx(blob)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tree = PI.variables_from_torch_state(got, resolve_model_name(blob))
    _assert_maps_match_spec(_port_module("yolov8n", tree), spec, sd, 2,
                            "yolov8")


def _fake_ultralytics_checkpoint(path, torch_sd, with_ema=False):
    """tests/test_onnx_lite.py's fabricated ultralytics .pt: classes under
    'ultralytics.*' module paths that do not import at load time, half
    precision tensors."""
    from torch import nn
    created = []
    for mn in ("ultralytics", "ultralytics.nn", "ultralytics.nn.tasks"):
        if mn not in sys.modules:
            sys.modules[mn] = types.ModuleType(mn)
            created.append(mn)
    detection_model = type("DetectionModel", (nn.Module,),
                           {"__module__": "ultralytics.nn.tasks"})
    sys.modules["ultralytics.nn.tasks"].DetectionModel = detection_model

    def build():
        root = detection_model()
        root.yaml = {"nc": 2}
        for name, arr in torch_sd.items():
            parts = name.split(".")
            node = root
            for p in parts[:-1]:
                child = node._modules.get(p)
                if child is None:
                    child = nn.Module()
                    node.add_module(p, child)
                node = child
            t = torch.tensor(np.asarray(arr), dtype=torch.float16)
            if parts[-1].startswith("running_"):
                node.register_buffer(parts[-1], t)
            else:
                node.register_parameter(parts[-1], nn.Parameter(t))
        return root

    torch.save({"model": build(), "ema": build() if with_ema else None,
                "epoch": 7, "train_args": {"imgsz": 768}}, path)
    for mn in created:
        del sys.modules[mn]


def test_pt_checkpoint_drill(tmp_path):
    """An ultralytics-style yolov8n .pt (EMA weights, half precision,
    unimportable classes) through the port's loader (equal to the JAX
    package's) and importer into the port's module, matching the upstream
    interpreter on the same (half-rounded) weights."""
    spec = yolov8_spec("n")
    sd = {k: np.float16(v).astype(np.float32)
          for k, v in make_state_dict(spec, nc=2, seed=5).items()}
    p = str(tmp_path / "yolov8_tokyo_checkpoint.pt")
    _fake_ultralytics_checkpoint(p, sd, with_ema=True)
    got, want = load_checkpoint_state(p), jax_load_checkpoint(p)
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    tree = PI.variables_from_torch_state(got, "yolov8n")
    _assert_maps_match_spec(_port_module("yolov8n", tree), spec, sd, 2,
                            "yolov8")


def test_pt_loader_never_executes_untrusted_globals(tmp_path):
    import pickle
    import zipfile
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    p = str(tmp_path / "evil.pt")
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("evil/data.pkl", pickle.dumps({"model": Evil()}))
        z.writestr("evil/version", "3\n")
    try:
        load_checkpoint_state(p)
    except Exception:
        pass                    # refusing the stream is fine too
    assert not marker.exists(), "untrusted pickle executed code"
    u = _StubUnpickler(io.BytesIO(b""))
    stub = u.find_class("os", "system")
    assert getattr(stub, "_aerial_stub_origin", None) == "os.system"
    stub("echo should-not-run")
    assert u.find_class("torch._utils", "_rebuild_tensor_v2") \
        is torch._utils._rebuild_tensor_v2
    assert u.find_class("torch", "float16") is torch.float16


def test_yolov7_base_variant_and_tiny_keep_their_forms():
    base = YOLOv7(variant="base")
    assert base.anchors[0] == ((12, 16), (19, 36), (40, 28))
    assert base.stem1.act == "silu" and base.rep3.conv.bias is not None \
        and isinstance(base.rep3.bn, torch.nn.Identity)
    tiny = YOLOv7(variant="tiny")
    assert tiny.stem0.act == "leaky" and tiny.stem0.conv.bias is None
    fold_batchnorm(base)
    assert isinstance(base.rep3.bn, torch.nn.Identity)


# ------------------------------------------------- family facts, pinned

# every registry name's family facts written out as literals: (model
# class, arch it builds, stem table or None, quad stem, NMS-free)
_TINY_STEMS = {"stems": ("stem0", "stem1"), "act": "leaky", "bn_eps": 1e-5,
               "strides": (2, 2)}
_BASE_STEMS = {"stems": ("stem0", "stem1", "stem2", "stem3"), "act": "silu",
               "bn_eps": 1e-5, "strides": (1, 2, 1, 2)}
_V8_STEMS = {"stems": ("stem", "down2"), "act": "silu", "bn_eps": 1e-3,
             "strides": (2, 2)}
FAMILY_FACTS = {
    "yolov7_itcvd": (YOLOv7, "tiny", _TINY_STEMS, True, False),
    "yolov7_base": (YOLOv7, "base", _BASE_STEMS, False, False),
    "yolov8_tokyo": (YOLOv8, "l", _V8_STEMS, True, False),
    **{f"yolov8{sc}": (YOLOv8, sc, _V8_STEMS, True, False)
       for sc in "nsmlx"},
    "rtdetr_r50vd": ("RTDETR", "", None, False, True),
    "xunet_256": ("XUnet", "", None, False, False),
}
_ANCHORS = {"tiny": ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                     (59, 119), (116, 90), (156, 198), (373, 326)),
            "base": ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55),
                     (72, 146), (142, 110), (192, 243), (459, 401))}


def _decode_by_family(cls, arch, nc, outs, size):
    """The decode each family's answer must equal, chosen by family."""
    from aerial_image_recognition_tpu_torch.ops.decode import decode_yolov7
    if cls == "XUnet":
        return outs
    if cls == "RTDETR":
        return outs["boxes"] * size, torch.sigmoid(outs["logits"])
    if cls is YOLOv8:
        return decode_yolov8(outs, nc)
    anchors = tuple(tuple(_ANCHORS[arch][3 * i:3 * i + 3]) for i in range(3))
    return decode_yolov7(outs, anchors, nc)


def _tensors(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


@pytest.mark.parametrize("name", sorted(FAMILY_FACTS) + ["s2d_stem"])
def test_family_facts_live_on_the_model_class(name):
    """Each registry model carries its family's facts on its class: the
    arch its spec builds, its stem table (each stem's stride, activation
    and BN epsilon as the module has them), whether the quad stem applies
    (not for yolov7-tiny with ``s2d_stem``), the detection prior and the
    NMS-free finish; ``ModelBundle.forward`` (and ``forward_s2d2``) equal
    that decode of the module's outputs bit for bit."""
    import dataclasses
    s2d = name == "s2d_stem"
    name = "yolov7_itcvd" if s2d else name
    cls, arch, table, quad, nms_free = FAMILY_FACTS[name]
    size = 128 if cls == "RTDETR" else 64      # ≥ 300 tokens for RT-DETR
    bundle = create_model(name, seed=1, dtype=torch.float32, device="cpu")
    spec, module = bundle.spec, bundle.module
    nc = spec.num_classes
    assert spec.arch == arch
    assert type(module).__name__ == getattr(cls, "__name__", cls)
    assert getattr(module, "variant", getattr(module, "scale", "")) == arch
    # the detection prior of a fresh random model
    if cls is YOLOv8:
        assert all(torch.all(getattr(module.detect, f"cls{i}_out").bias
                             == -5.0) for i in range(3))
    elif cls is YOLOv7:
        no = 5 + nc
        assert all(torch.all(h.bias[a * no + 4:(a + 1) * no] == -5.0)
                   for h in module.heads() for a in range(3))
    else:
        assert not hasattr(module, "init_detect_prior")
    if s2d:
        module = YOLOv7(num_classes=1, variant="tiny", s2d_stem=True).eval()
        bundle = dataclasses.replace(bundle, module=module)
        table, quad = dict(table, strides=(1, 2)), False
    assert getattr(module, "stem_table", None) == table
    assert bundle.supports_s2d2() is quad
    assert getattr(module, "nms_free", False) is nms_free
    for stem, stride in zip(*((table["stems"], table["strides"])
                              if table else ((), ()))):
        block = getattr(module, stem)
        assert block.conv.stride == (stride, stride)
        assert (block.act, block.bn.eps) == (table["act"], table["bn_eps"])
    x = torch.rand(2, 3, size, size,
                   generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        pairs = [(bundle.forward(x),
                  _decode_by_family(cls, arch, nc, module(x), size))]
        if quad:
            xq = torch.randint(0, 256, (2, size // 4, size // 4, 48),
                               dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(4))
            p2 = bundle.quad_stem()(xq)
            pairs.append((bundle.forward_s2d2(xq), _decode_by_family(
                cls, arch, nc, module(p2, from_p2=True), size)))
    for got, want in pairs:
        got, want = _tensors(got), _tensors(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, w)
