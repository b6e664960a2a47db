"""Guard tests for the port's rules.

The port package and chip_smoke.py import torch, numpy and the standard
library, never JAX, flax, optax, orbax or the JAX package (whose name the port's shares as
a prefix, hence the exact top-level comparison). Entry points run on CUDA
unless given a device, and raise instead of falling back to the CPU.
"""

import ast
import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "aerial_image_recognition_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "aerial_image_recognition_tpu"}


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


def _imported_top_levels(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    bad = [(name, line) for name, line in _imported_top_levels(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_check_covers_the_numpy_copies():
    """The upstream importers the port keeps its own copies of are checked
    like every other module: they import nothing of the JAX package."""
    names = {str(p.relative_to(PORT)) for p in _port_sources()
             if PORT in p.parents}
    assert {"models/import_torch.py", "models/torch_pt.py",
            "models/onnx_lite.py", "models/yolov8.py"} <= names
    # the city scan's host half (its own copies of the JAX package's numpy,
    # fetch and I/O modules)
    assert {"geo/__init__.py", "geo/ellipsoid.py", "geo/tmerc.py",
            "geo/webmercator.py", "geo/crs.py", "geo/polygon.py",
            "geo/tiles.py", "gio/geojson.py", "gio/shapefile.py",
            "gio/decode.py", "utils/native.py", "runtime/checkpoint.py",
            "runtime/observability.py", "post/dedup.py", "post/results.py",
            "post/heatmap.py", "fetch/__init__.py", "fetch/http.py",
            "fetch/cache.py", "fetch/xyz.py", "fetch/wms.py",
            "fetch/wmts.py", "fetch/fake.py", "ingest/pipeline.py",
            "pipeline/detector.py"} <= names
    # segmentation (the copies of mask_to_polygons and automask's numpy)
    assert {"models/xunet.py", "pipeline/rasters.py",
            "pipeline/automask.py", "pipeline/serve.py"} <= names
    # training: the trainer that replaces optax and orbax, the numpy data
    # pipeline and metrics
    assert {"ops/losses.py", "ops/metrics.py", "pipeline/data.py",
            "pipeline/train.py", "runtime/train_ckpt.py"} <= names
    # and the native sources it builds are the port's own copies
    assert {p.name for p in (PORT / "native").glob("*.cpp")} == {
        "fastgeo.cpp", "fastdecode.cpp", "fastpack.cpp"}


def test_import_check_sees_the_prefix_package(tmp_path):
    """The check compares whole names: the port's own package passes, the
    JAX package of the same prefix, and imports inside functions, do not."""
    src = tmp_path / "snippet.py"
    src.write_text("import aerial_image_recognition_tpu_torch.ops\n"
                   "def f():\n"
                   "    from aerial_image_recognition_tpu.ops import nms\n"
                   "    import jax.numpy as jnp\n")
    found = [name in FORBIDDEN for name, _ in _imported_top_levels(src)]
    assert sorted(found) == [False, True, True]


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    """Without CUDA and without a device every entry point that builds a
    model raises, before it reads an input file or fetches a tile: the
    library calls and the CLI's model-building verbs alike."""
    from aerial_image_recognition_tpu_torch.gio.geotiff import write_geotiff
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline import (
        automask, cli, rasters, simple)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.pipeline.predict import (
        predict_images)
    from aerial_image_recognition_tpu_torch.pipeline.serve import (
        DetectionServer)
    from aerial_image_recognition_tpu_torch.pipeline.sweep import run_sweep

    def no_input(*a, **kw):
        raise AssertionError("an input was read before the device check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(rasters, "read_geotiff", no_input)
    monkeypatch.setattr(automask, "read_geotiff", no_input)
    monkeypatch.setattr(simple, "XYZFetcher", no_input)
    tif = str(tmp_path / "in.tif")
    write_geotiff(tif, np.zeros((8, 8, 3), np.uint8),
                  (21.0, 1e-5, 0.0, 52.2, 0.0, -1e-5), 4326)
    calls = [build_detect_step, create_model, DetectionServer,
             lambda: predict_images([tif]),
             lambda: rasters.detect_geotiff(tif),
             lambda: rasters.segment_geotiff(tif),
             lambda: automask.automask_geotiff(tif),
             lambda: DetectionServer(
                 detect_step=types.SimpleNamespace(batch=1, input_size=8),
                 segment_params="xunet.npz"),
             lambda: simple.SimpleDetector(output_dir=str(tmp_path)),
             lambda: run_sweep(str(tmp_path), {"frame_path": "missing"},
                               tile_sizes=(64.0,))]
    for argv in (["detect", "--frame", "missing.geojson"],
                 ["sweep", "--frame", "missing.geojson"],
                 ["geotiff", tif], ["predict", tif], ["serve"],
                 ["automask", tif],
                 ["calibrate", tif, "--out", str(tmp_path / "c.json")],
                 ["export", "missing.npz", str(tmp_path / "m.onnx")],
                 ["import-weights", "missing.onnx", "--out",
                  str(tmp_path / "w.npz")],
                 ["train", "--coco", "missing.json", "--images",
                  str(tmp_path), "--out", str(tmp_path / "t.npz")],
                 ["val", "--coco", "missing.json", "--images",
                  str(tmp_path)]):
        calls.append(lambda argv=argv: cli.main(argv))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(device="cuda")


def test_car_detector_refuses_to_fall_back_to_cpu(monkeypatch, tmp_path):
    """Without an injected step, ``detect()`` builds its step on ``cuda``
    and raises without CUDA — before it reads the frame or fetches a tile
    (the default WMS endpoint is never contacted)."""
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)

    def no_network(*a, **kw):
        raise AssertionError("the scan reached the fetch plane")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    det = CarDetector(str(tmp_path))
    monkeypatch.setattr(det, "_load_frame", no_network)
    monkeypatch.setattr(det, "_make_fetcher", no_network)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        det.detect(force_restart=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CarDetector(str(tmp_path), device="cuda").detect()


def test_nms_wrapper_on_cpu_is_the_plain_version_and_builds_nothing(
        monkeypatch):
    """A CPU tensor goes to ``_suppress_plain`` and never near the kernel's
    build (there is no nvcc on a CPU-only machine)."""
    import numpy as np

    from aerial_image_recognition_tpu_torch.kernels import build
    from aerial_image_recognition_tpu_torch.ops.nms import _suppress_plain
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)

    def no_build(*a, **kw):
        raise AssertionError("the CPU path reached kernels.build")

    for name in ("load", "build_all", "_start", "_nvcc"):
        monkeypatch.setattr(build, name, no_build)
    rng = np.random.default_rng(5)
    boxes_t = torch.from_numpy(
        rng.uniform(0, 64, (2, 4, 24)).astype(np.float32))
    scores = torch.from_numpy(
        np.sort(rng.uniform(0, 1, (2, 24)).astype(np.float32))[:, ::-1]
        .copy())
    classes = torch.from_numpy(rng.integers(0, 3, (2, 24)).astype(np.int32))
    kw = dict(iou_threshold=0.45, max_det=8, class_aware=True)
    before = nms_suppress.launches
    got = nms_suppress(boxes_t, scores, classes, **kw)
    want = _suppress_plain(boxes_t, scores, classes, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert nms_suppress.launches == before


def test_unported_options_raise(tmp_path):
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    # a mesh builds the data-parallel step, float and turnkey int8
    from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(["cpu"] * 2)
    dp = build_detect_step(device="cpu", mesh=mesh, batch=2, model_size=64)
    assert dp.input_shardings == mesh.rows(2) and len(dp.shard_fns) == 2
    dq = build_detect_step(DetectorConfig(extra={"quantize": "int8"}),
                           device="cpu", mesh=mesh, batch=2, model_size=64)
    assert dq.quantize_state == "calibrating"
    assert dq.input_shardings == mesh.rows(2)
    # the reference resizes multiscale's off-native scales with
    # jax.image.resize when resize_matmul is false: the port's counterpart
    # of it (ops/preprocess.resize) runs there, never the matrix resize
    from aerial_image_recognition_tpu_torch.ops import preprocess
    from aerial_image_recognition_tpu_torch.pipeline import inference
    calls = {"resize": 0, "matmul_resize_float": 0}

    def counted(name):
        fn = getattr(inference, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    img = np.zeros((2, 128, 128, 3), np.uint8)   # scales 96, 128, 160 px
    bnd = np.tile(np.float32([[21.0, 52.0, 21.001, 52.001]]), (2, 1))
    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(inference, name, counted(name))
        for scales, mm, want in (([0.85, 1.0, 1.15], False, (2, 0)),
                                 ([0.85, 1.0, 1.15], True, (0, 2)),
                                 ([1.0], False, (0, 0))):
            calls.update(resize=0, matmul_resize_float=0)
            step = build_detect_step(DetectorConfig(extra={
                "multiscale": scales, "resize_matmul": mm}),
                device="cpu", batch=2, model_size=128)
            step(img, bnd)
            assert (calls["resize"], calls["matmul_resize_float"]) == want
    assert preprocess.resize is inference.resize
    build_detect_step(DetectorConfig(extra={"resize_matmul": False}),
                      device="cpu", model_size=64)      # single-scale: fine
    # the scan's data-parallel mesh and the quad stem's batch layout, both
    # ported (the heatmap's GeoPackage output, refused until the writer was
    # ported, now writes its layer)
    from aerial_image_recognition_tpu_torch.ingest.pipeline import (
        assemble_batches)
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    from aerial_image_recognition_tpu_torch.post.heatmap import hex_heatmap
    for flag, n in ((True, 1), (4, 4)):
        det = CarDetector(".", {"data_parallel": flag}, device="cpu")
        assert det._make_mesh().devices == (torch.device("cpu"),) * n
    assert CarDetector(".", {"data_parallel": False})._make_mesh() is None
    assert list(assemble_batches(iter([]), batch_size=2, src_size=8,
                                 layout="s2d2")) == []
    from aerial_image_recognition_tpu_torch.gio.geopackage import read_gpkg
    heat = str(tmp_path / "heat.gpkg")
    hex_heatmap([{"lon": 21.0, "lat": 52.2, "confidence": 0.5}], 50.0,
                output_geojson=heat)
    assert read_gpkg(heat)["layer"] == "hex_heatmap_output"
    # the segmentation model resolves and builds as in the JAX package
    from aerial_image_recognition_tpu.models.registry import (
        resolve_model_name as jax_resolve_model_name)
    for name in ("xunet_256", "ramp_XUnet_256.onnx"):
        assert jax_resolve_model_name(name) == "xunet_256"
        bundle = create_model(name, device="cpu", dtype=torch.float32)
        assert bundle.spec.name == "xunet_256"
        assert bundle.spec.family == "xunet"
    # the quad-stem entry, and with it the fully-int8 stems, of both
    # detector families that have the lowering (once refused here)
    from aerial_image_recognition_tpu_torch.models.int8 import (
        quantize_bundle)
    for name in ("yolov7_itcvd", "yolov8n"):
        bundle = create_model(name, device="cpu", dtype=torch.float32)
        assert bundle.supports_s2d2()
        qb = quantize_bundle(bundle, [torch.zeros(1, 64, 64, 3,
                                                  dtype=torch.uint8)],
                             model_size=64)
        assert qb.supports_s2d2() and "stems" in qb.q
        boxes, scores = qb.forward_s2d2(torch.zeros(1, 16, 16, 48,
                                                    dtype=torch.uint8))
        assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    # quantize_bundle dispatches an xunet bundle to quantize_xunet, as the
    # JAX package's does
    xunet = create_model("xunet_256", device="cpu", dtype=torch.float32)
    qx = quantize_bundle(xunet, [np.zeros((1, 64, 64, 3), np.uint8)],
                         model_size=64)
    assert type(qx).__name__ == "Int8XUnetBundle"
    # RT-DETR has no int8 lowering: its step refuses quantize="int8", with
    # or without a saved calibration, instead of self-calibrating
    rt = create_model("rtdetr_r50vd", device="cpu", dtype=torch.float32)
    for extra in ({"quantize": "int8"},
                  {"quantize": "int8", "quantize_calib": "absmax.json"}):
        with pytest.raises(NotImplementedError, match="rtdetr"):
            build_detect_step(DetectorConfig(
                model_path="rtdetr_r50vd", model_family="rtdetr",
                num_classes=2, extra=extra), bundle=rt, device="cpu")


@pytest.mark.parametrize("flag", [2, True])
def test_server_builds_a_data_parallel_step(monkeypatch, flag):
    """The reference shards the serving batch over a mesh when
    ``data_parallel`` is set; so does the port's server: its step is built
    over ``mesh_from_flag`` (on the CPU, that many CPU shards; True is
    one), never quietly on one device."""
    from aerial_image_recognition_tpu_torch.pipeline import inference
    from aerial_image_recognition_tpu_torch.pipeline.serve import (
        DetectionServer)
    meshes = []

    def spy(cfg, *, batch, mesh, device):
        meshes.append(mesh)
        assert str(device) == "cpu" and batch == 4
        return _StubStep()

    monkeypatch.setattr(inference, "build_detect_step", spy)
    srv = DetectionServer({"data_parallel": flag, "device_batch": 4},
                          device="cpu")
    srv._httpd.server_close()
    n = 1 if flag is True else flag
    assert meshes[0].devices == (torch.device("cpu"),) * n
    srv = DetectionServer({"data_parallel": None, "device_batch": 4},
                          device="cpu")
    srv._httpd.server_close()
    assert meshes[1] is None                    # unset: one device


class _StubStep:
    """The surface a DetectionServer reads from its step, nothing more."""
    batch, input_size, model_size = 1, 8, 8


class _FakeCudaTensor:
    """Just enough of a tensor on the card for a wrapper's dispatch."""
    device = torch.device("cuda", 0)
    shape = (2, 3, 3, 8)
    is_cuda = True

    def __init__(self, dtype):
        self.dtype = dtype

    def dim(self):
        return 4

    def numel(self):
        return 144

    def is_contiguous(self):
        return True


def test_int8_wrappers_never_reach_the_plain_version_on_the_card(
        monkeypatch):
    """A CUDA tensor goes to the integer product / the epilogue kernel or
    raises; a tensor of any other device raises; neither reaches the plain
    version, and nothing widens to float."""
    from aerial_image_recognition_tpu_torch.models import int8
    from aerial_image_recognition_tpu_torch.ops import int8_kernel
    reached = []
    monkeypatch.setattr(int8, "_conv_s32_plain",
                        lambda *a: reached.append("conv plain"))
    monkeypatch.setattr(int8, "_conv_s32_card",
                        lambda *a: reached.append("conv card"))
    monkeypatch.setattr(int8_kernel, "_requantize_plain",
                        lambda *a: reached.append("epilogue plain"))
    int8.conv_s32(_FakeCudaTensor(torch.int8), None, 3, 1)
    assert reached == ["conv card"]
    with pytest.raises(Exception):      # no CUDA here: the launch path raises
        int8_kernel.requantize(_FakeCudaTensor(torch.int32), None, None)
    assert reached == ["conv card"]
    ragged = _FakeCudaTensor(torch.int32)
    ragged.shape = (2, 3, 3, 6)         # the kernel takes multiples of 4
    with pytest.raises(ValueError, match="multiples of 4"):
        int8_kernel.requantize(ragged, None, None)
    assert reached == ["conv card"]
    launches = int8_kernel.requantize.launches
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no integer product"):
        int8.conv_s32(torch.zeros(1, 2, 2, 8, dtype=torch.int8, device=meta),
                      None, 1)
    with pytest.raises(ValueError, match="no kernel"):
        int8_kernel.requantize(
            torch.zeros(4, 8, dtype=torch.int32, device=meta),
            torch.zeros(8, device=meta), torch.zeros(8, device=meta))
    with pytest.raises(ValueError, match="int8"):
        int8.conv_s32(torch.zeros(1, 2, 2, 8), None, 1)     # float in
    assert reached == ["conv card"]
    assert int8_kernel.requantize.launches == launches


def test_int8_wrappers_on_cpu_are_the_plain_versions_and_build_nothing(
        monkeypatch):
    import numpy as np

    from aerial_image_recognition_tpu_torch.kernels import build
    from aerial_image_recognition_tpu_torch.models import int8
    from aerial_image_recognition_tpu_torch.ops import int8_kernel

    def no_build(*a, **kw):
        raise AssertionError("the CPU path reached kernels.build")

    for name in ("load", "build_all", "_start", "_nvcc"):
        monkeypatch.setattr(build, name, no_build)
    monkeypatch.setattr(int8, "_conv_s32_card", no_build)
    rng = np.random.default_rng(6)
    v = torch.from_numpy(rng.integers(-127, 128, (2, 5, 5, 8), dtype=np.int8))
    w8 = rng.integers(-127, 128, (3, 3, 8, 16), dtype=np.int8)
    w = int8.device_kernel(w8, torch.device("cpu"))
    r = int8.conv_s32(v, w, 3, 2)
    assert r.dtype == torch.int32 and tuple(r.shape) == (2, 3, 3, 16)
    assert torch.equal(r, int8._conv_s32_plain(v, w, 3, 2))
    m, b = torch.full((16,), 1e-3), torch.zeros(16)
    launches = int8_kernel.requantize.launches
    codes = int8_kernel.requantize(r, m, b)
    assert torch.equal(codes, int8_kernel._requantize_plain(r, m, b, None,
                                                            "leaky"))
    assert int8_kernel.requantize.launches == launches


def test_config_is_a_faithful_copy():
    from aerial_image_recognition_tpu.runtime.config import (
        DEFAULT_CONFIG as JAX_DEFAULT, DetectorConfig as JaxConfig)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DEFAULT_CONFIG, DetectorConfig)
    jf = [(f.name, f.type) for f in dataclasses.fields(JaxConfig)]
    pf = [(f.name, f.type) for f in dataclasses.fields(DetectorConfig)]
    assert pf == jf
    assert DEFAULT_CONFIG == JAX_DEFAULT
    d = {"confidence_threshold": 0.5, "nms_pre_topk": 128, "dtype": "float32"}
    assert DetectorConfig.from_dict(d).to_dict() == \
        JaxConfig.from_dict(d).to_dict()
    with pytest.raises(ValueError):
        DetectorConfig.from_dict({"tile_overlap": 1.5})


def test_decode_rgb_reads_png_and_jpeg_and_rejects_junk():
    import io

    import numpy as np
    from PIL import Image

    from aerial_image_recognition_tpu_torch.gio.decode import decode_rgb
    img = np.random.default_rng(0).integers(0, 255, (9, 7, 3), np.uint8)
    for fmt in ("PNG", "JPEG"):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt)
        out = decode_rgb(buf.getvalue())
        assert out.shape == (9, 7, 3) and out.dtype == np.uint8
        if fmt == "PNG":
            assert (out == img).all()
    assert decode_rgb(b"") is None and decode_rgb(b"not an image") is None
