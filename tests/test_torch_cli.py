"""The port's command line (``python -m aerial_image_recognition_tpu_torch``)
against the JAX package's.

``train`` and ``val`` (``--device cpu``) run the same argv as the JAX
verbs on a COCO set of 12 FakeWorld tiles (96 px at the trained fixture's
0.5 m/px, exact boxes), fine-tuning the trained fixture with
``--freeze 0,1,2``: final loss within rtol 1e-3 and mAP50 within 0.02
(two epochs of Adam, whose noise-level sign flips move a leaf by 2·lr a
step), the checkpoints of both verbs load in both packages with the same
keys and shapes, their params within 4·lr·steps, the frozen layers equal
to the fixture's; ``val``'s metrics equal the JAX verb's within 1e-6.

The parser: the same verbs, every one answering ``--help``, and
``_overrides`` giving the same config dict for the same argv; ``--device``
(the port's one flag of its own) never lands in the config. Every verb the
port has not ported yet, and ``--data-parallel`` on detect, sweep and
serve, raises NotImplementedError naming what brings it (``train`` has no
such flag in either package: argparse refuses it); without ``--device``
and without CUDA a verb that builds a model exits non-zero before it
fetches anything.

Each ported verb runs on the CPU with ``--device cpu``. ``detect`` over
each package's fake XYZ server (640-px windows at zoom 18, so both steps
send them through the quad stem; the trained fixture in the config's bf16
in both): the same tiles, record counts within 2 %, and ≥ 0.98 of each
package's records within 0.1 m and 0.01 in confidence of one of the
other's (bf16 trunks summed in another order; while the port ran plain
stems here the bar was 10 %, 0.9, 1 m and 0.05). ``import-weights`` and
``export`` equal the JAX verbs' arrays and bytes; ``calibrate`` gives the
JAX verb's absmax within rtol 1e-5 (the tolerance
``tests/test_torch_int8.py`` holds ``calibrate_absmax`` to: this side
folds BN).
"""

import argparse
import base64
import io
import json
import math
import os
import signal
import subprocess
import sys
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from aerial_image_recognition_tpu.fetch import fake as JF
from aerial_image_recognition_tpu.gio.geotiff import (
    write_geotiff as jax_write_geotiff)
from aerial_image_recognition_tpu.models.import_torch import (
    torch_state_from_variables as jax_torch_state)
from aerial_image_recognition_tpu.models.onnx_lite import (
    load_onnx_initializers, write_minimal_onnx)
from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model, load_params as jax_load_params)
from aerial_image_recognition_tpu.pipeline import cli as JC
from aerial_image_recognition_tpu_torch.fetch import fake as PF
from aerial_image_recognition_tpu_torch.geo.webmercator import (
    meters_per_pixel)
from aerial_image_recognition_tpu_torch.gio.geojson import (
    read_geojson, write_geojson)
from aerial_image_recognition_tpu_torch.models.registry import (
    create_model, save_params)
from aerial_image_recognition_tpu_torch.models.weights import load_params
from aerial_image_recognition_tpu_torch.pipeline import cli as PC
from aerial_image_recognition_tpu_torch.runtime import doctor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "yolov7_tiny_fakeworld.npz")
WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.01, n_cars=400,
             seed=4)
M2LON = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
M2LAT = 1.0 / 111319.9

# the tests run beside others in parallel workers: two threads each, and
# as many for the CLI processes they start
torch.set_num_threads(2)
CHILD_THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}


class _Parsed(Exception):
    pass


def _parse(main, argv):
    """(namespace, top-level parser) of ``main(argv)``, stopped right after
    its argparse call: the same route for both packages' CLIs."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen["ns"], seen["parser"] = real(self, args, namespace), self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", spy):
        with pytest.raises(_Parsed):
            main(argv)
    return seen["ns"], seen["parser"]


def _verbs(parser):
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return list(action.choices)


VERBS = ["detect", "sweep", "bench", "doctor", "train", "geotiff", "serve",
         "automask", "predict", "val", "export", "import-weights",
         "calibrate"]


def test_verbs_equal_jax():
    _, port = _parse(PC.main, ["doctor"])
    _, jax = _parse(JC.main, ["doctor"])
    assert _verbs(port) == _verbs(jax) == VERBS


@pytest.mark.parametrize("verb", VERBS)
def test_every_verb_answers_help(verb, capsys):
    with pytest.raises(SystemExit) as e:
        PC.main([verb, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage: aerial_image_recognition_tpu_torch " + verb)
    with pytest.raises(SystemExit):
        JC.main([verb, "--help"])
    jax_opts = {w for w in capsys.readouterr().out.split() if
                w.startswith("--")}
    port_opts = {w for w in out.split() if w.startswith("--")}
    # the same flags, and --device on the verbs that build a model
    assert port_opts - {"--device", "--device DEVICE"} == jax_opts - {
        "--device"}
    builds = verb in ("detect", "sweep", "train", "geotiff", "serve",
                      "automask", "predict", "val", "export",
                      "import-weights", "calibrate")
    assert ("--device" in port_opts) == builds


@pytest.mark.parametrize("argv", [
    ["detect"],
    ["detect", "--frame", "warsaw.shp", "--use-xyz", "--xyz-url", "u/{z}",
     "--zoom", "19", "--tile-size-meters", "64", "--tile-overlap", "0.25",
     "--confidence-threshold", "0.35", "--batch-size", "200",
     "--device-batch", "32", "--checkpoint-interval", "500",
     "--duplicate-distance", "1.5", "--num-workers", "12",
     "--output-prefix", "run", "--event-log", "ev.jsonl", "--params",
     "w.npz", "--force-restart", "--interactive"],
    ["detect", "--tta", "--multiscale", "0.85,1,1.15", "--heatmap-hex", "50",
     "--enhance-shadows", "--quantize", "int8", "--quantize-calib", "c.json",
     "--model", "yolov8_tokyo", "--base-dir", "/tmp/x"],
    ["detect", "--data-parallel"],
    ["sweep", "--data-parallel", "4", "--tile-sizes", "100,50",
     "--wms-url", "http://w", "--wms-layer", "ortho"],
    ["sweep", "--frame", "aoi.geojson", "--multiscale", "1"],
], ids=["bare", "every-scalar", "modes", "dp-const", "sweep-dp", "sweep"])
def test_overrides_equal_jax(argv):
    ns_p, _ = _parse(PC.main, argv)
    ns_j, _ = _parse(JC.main, argv)
    assert PC._overrides(ns_p) == JC._overrides(ns_j)
    ns_d, _ = _parse(PC.main, argv + ["--device", "cpu"])
    assert ns_d.device == "cpu" and PC._overrides(ns_d) == PC._overrides(ns_p)


def test_params_reach_the_model(tmp_path):
    """--params loads the checkpoint into the detect step (the JAX
    package's round-1 finding: parsed, then dropped)."""
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    ns, _ = _parse(PC.main, ["detect", "--params", "weights.npz"])
    assert PC._overrides(ns)["params_path"] == "weights.npz"
    with pytest.raises(FileNotFoundError):
        create_model("yolov7_itcvd", params_path=str(tmp_path / "no.npz"),
                     device="cpu")
    donor = create_model("yolov7_itcvd", dtype=torch.float32, seed=3,
                         device="cpu")
    ckpt = str(tmp_path / "w.npz")
    save_params(donor.variables, ckpt)
    ns, _ = _parse(PC.main, ["detect", "--params", ckpt])
    cfg = DetectorConfig().merged(dict(PC._overrides(ns), dtype="float32"))
    step = build_detect_step(cfg, batch=1, device="cpu")
    got = step.bundle.variables
    for col in ("params", "batch_stats"):
        flat_g = _flat(got[col])
        flat_w = _flat(donor.variables[col])
        assert flat_g.keys() == flat_w.keys()
        for k in flat_w:
            np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("argv,slice_", [
    (["bench"], "benchmark"),
], ids=["bench"])
def test_unported_verbs_and_flags_raise(argv, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        PC.main(argv)


def test_train_refuses_data_parallel_as_jax(capsys):
    """``train`` has no ``--data-parallel`` in either package: argparse
    refuses it (exit 2) before anything is read. Data-parallel training
    is a library call in both (``fit``/``make_train_step`` with ``mesh``,
    ``tests/test_torch_parallel_train.py``)."""
    argv = ["train", "--coco", "c.json", "--images", "im", "--out",
            "o.npz", "--data-parallel", "2"]
    for main in (PC.main, JC.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        assert "unrecognized arguments: --data-parallel 2" \
            in capsys.readouterr().err


# --------------------------------------------------------------- detect

def _aoi(base, w, s, e, n):
    frame = os.path.join(base, "aoi.geojson")
    write_geojson({"type": "FeatureCollection", "features": [{
        "type": "Feature", "properties": {}, "geometry": {
            "type": "Polygon", "coordinates": [[[w, s], [e, s], [e, n],
                                                [w, n], [w, s]]]}}]}, frame)
    return frame


def test_detect_without_a_device_exits_before_any_fetch(tmp_path,
                                                        monkeypatch):
    from aerial_image_recognition_tpu_torch.pipeline import detector
    srv = PF.FakeTileServer(PF.FakeWorld(n_cars=5))
    srv.start()
    try:
        frame = _aoi(str(tmp_path), 20.999, 52.199, 21.001, 52.201)
        argv = ["detect", "--base-dir", str(tmp_path), "--frame", frame,
                "--use-xyz", "--xyz-url", srv.xyz_template, "--zoom", "18"]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(detector.CarDetector, "_load_frame",
                            lambda self: pytest.fail("the frame was read"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PC.main(argv)
        # and as a process: a non-zero exit, the error on stderr, no tile
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **CHILD_THREADS)
        proc = subprocess.run(
            [sys.executable, "-m", "aerial_image_recognition_tpu_torch"]
            + argv, cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
        assert srv.request_count == 0
    finally:
        srv.stop()


def _detect_records(base):
    doc = read_geojson(os.path.join(base, "output",
                                    "detections_results.geojson"))
    return np.array([[f["geometry"]["coordinates"][0] / M2LON,
                      f["geometry"]["coordinates"][1] / M2LAT,
                      f["properties"]["confidence"]]
                     for f in doc["features"]])


def _matched_frac(a, b, metres=1.0, conf=0.05):
    """Fraction of a's records with a record of b within ``metres`` and
    ``conf``."""
    d = np.linalg.norm(a[:, None, :2] - b[None, :, :2], axis=2)
    ok = (d <= metres) & (np.abs(a[:, None, 2] - b[None, :, 2]) <= conf)
    return float(ok.any(axis=1).mean())


def test_detect_on_the_cpu_equals_jax_cli(tmp_path, capsys):
    zoom, lat = 18, 52.2
    tile_m = 640.5 * float(meters_per_pixel(zoom, lat=lat, xp=np))
    outs = {}
    for pkg, fake, main, extra in (("port", PF, PC.main, ["--device", "cpu"]),
                                   ("jax", JF, JC.main, [])):
        base = str(tmp_path / pkg)
        os.makedirs(base)
        frame = _aoi(base, 20.9985, 52.199, 21.0015, 52.201)
        srv = fake.FakeTileServer(fake.FakeWorld(**WORLD))
        srv.start()
        try:
            assert main(["detect", "--base-dir", base, "--frame", frame,
                         "--use-xyz", "--xyz-url", srv.xyz_template,
                         "--zoom", str(zoom), "--tile-size-meters",
                         str(tile_m), "--params", FIXTURE,
                         "--device-batch", "4", "--batch-size", "4",
                         "--num-workers", "8", "--confidence-threshold",
                         "0.3", "--force-restart"] + extra) == 0
        finally:
            srv.stop()
        outs[pkg] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    assert outs["port"].keys() == outs["jax"].keys()
    assert outs["port"]["tiles"] == outs["jax"]["tiles"] >= 4
    got, want = (_detect_records(str(tmp_path / p)) for p in ("port", "jax"))
    assert len(want) >= 10
    assert abs(len(got) - len(want)) <= 0.02 * len(want)
    assert _matched_frac(got, want, 0.1, 0.01) >= 0.98 \
        and _matched_frac(want, got, 0.1, 0.01) >= 0.98


def _serve_replies(argv, images, bboxes, env=None):
    """Start ``argv`` (a ``serve`` child), POST each image as a PNG with
    its bounds, SIGINT it; its replies and exit code."""
    proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        url = json.loads(proc.stdout.readline())["serving"]
        bodies = []
        for img, bbox in zip(images, bboxes):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "PNG")
            q = "&".join(f"{k}={v!r}" for k, v in zip(
                ("west", "south", "east", "north"), bbox))
            req = urllib.request.Request(f"{url}/detect?{q}",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                bodies.append(json.load(r))
        proc.send_signal(signal.SIGINT)
        return bodies, proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("verb", ["detect", "sweep", "serve"])
def test_data_parallel_on_the_cpu_equals_jax_cli(verb, tmp_path, capsys,
                                                 monkeypatch):
    """``--data-parallel 2 --device cpu`` shards the batch over two CPU
    shards and gives what the JAX CLI's ``--data-parallel 2`` gives over
    two of its virtual devices (the single-device test's bar: every record
    matched within 1 m and 0.05 confidence, both ways; the server's
    replies within 1 m)."""
    from aerial_image_recognition_tpu_torch.parallel import mesh as PM
    made = []
    real = PM.mesh_from_flag
    monkeypatch.setattr(PM, "mesh_from_flag",
                        lambda *a: made.append(real(*a)) or made[-1])
    if verb == "serve":
        bboxes, images = [], []
        for k, (lon, lat) in enumerate([(21.0, 52.2), (20.998, 52.201)]):
            bbox = (lon - 160 * M2LON, lat - 160 * M2LAT,
                    lon + 160 * M2LON, lat + 160 * M2LAT)
            bboxes.append(bbox)
            images.append(PF.FakeWorld(**WORLD).render(bbox, 640, 640))
        args = ["serve", "--port", "0", "--params", FIXTURE, "--batch", "2",
                "--max-wait-ms", "5", "--data-parallel", "2"]
        port, rc_p = _serve_replies(
            [sys.executable, "-m", "aerial_image_recognition_tpu_torch"]
            + args + ["--device", "cpu"], images, bboxes,
            dict(os.environ, **CHILD_THREADS))
        jax_env = dict(os.environ, **CHILD_THREADS, JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count=2")
        jx, rc_j = _serve_replies(
            [sys.executable, "-m", "aerial_image_recognition_tpu"] + args,
            images, bboxes, jax_env)
        assert rc_p == rc_j == 0
        for a, b in zip(port, jx):
            assert a["count"] == b["count"] >= 3
            ga = np.array([[d["lon"] / M2LON, d["lat"] / M2LAT]
                           for d in a["detections"]])
            gb = np.array([[d["lon"] / M2LON, d["lat"] / M2LAT]
                           for d in b["detections"]])
            d = np.linalg.norm(ga[:, None] - gb[None], axis=2)
            assert (d.min(axis=1) <= 1.0).all() and \
                (d.min(axis=0) <= 1.0).all()
        return
    zoom, lat = 18, 52.2
    tile_m = 640.5 * float(meters_per_pixel(zoom, lat=lat, xp=np))
    recs = {}
    for pkg, fake, main, extra in (("port", PF, PC.main, ["--device", "cpu"]),
                                   ("jax", JF, JC.main, [])):
        base = str(tmp_path / pkg)
        os.makedirs(base)
        frame = _aoi(base, 20.9985, 52.199, 21.0015, 52.201)
        srv = fake.FakeTileServer(fake.FakeWorld(**WORLD))
        srv.start()
        sizes = ["--tile-sizes", f"{tile_m!r}"] if verb == "sweep" \
            else ["--tile-size-meters", str(tile_m), "--force-restart"]
        try:
            assert main([verb, "--base-dir", base, "--frame", frame,
                         "--use-xyz", "--xyz-url", srv.xyz_template,
                         "--zoom", str(zoom), "--params", FIXTURE,
                         "--device-batch", "4", "--batch-size", "4",
                         "--num-workers", "8", "--confidence-threshold",
                         "0.3", "--data-parallel", "2"] + sizes + extra) \
                == 0
        finally:
            srv.stop()
        capsys.readouterr()
        if verb == "sweep":
            out = os.path.join(base, "output")
            (name,) = [f for f in os.listdir(out)
                       if f.endswith("m_results.geojson")]
            os.replace(os.path.join(out, name), os.path.join(
                out, "detections_results.geojson"))
        recs[pkg] = _detect_records(base)
    assert [m.devices for m in made] == [(torch.device("cpu"),) * 2]
    got, want = recs["port"], recs["jax"]
    assert len(want) >= 10
    assert abs(len(got) - len(want)) <= 0.1 * len(want)
    assert _matched_frac(got, want) >= 0.9 and _matched_frac(want, got) >= 0.9


def test_sweep_on_the_cpu(tmp_path, capsys):
    srv = PF.FakeTileServer(PF.FakeWorld(**WORLD))
    srv.start()
    try:
        frame = _aoi(str(tmp_path), 20.999, 52.1995, 21.001, 52.2005)
        assert PC.main(["sweep", "--base-dir", str(tmp_path), "--frame",
                        frame, "--use-xyz", "--xyz-url", srv.xyz_template,
                        "--zoom", "17", "--tile-sizes", "150,100",
                        "--params", FIXTURE, "--device-batch", "4",
                        "--num-workers", "8", "--device", "cpu"]) == 0
    finally:
        srv.stop()
    text = capsys.readouterr().out
    out = json.loads(text[text.rindex("\n[") + 1:])
    assert [r["tile_size_m"] for r in out] == [150.0, 100.0]
    assert all("error" not in r for r in out)
    assert out[1]["tiles"] > out[0]["tiles"]
    for r in out:
        name = f"detections_{r['tile_size_m']:g}m_results.geojson"
        doc = read_geojson(str(tmp_path / "output" / name))
        assert len(doc["features"]) == r["detections"]


# -------------------------------------------------- rasters and images

def _raster(tmp_path, side=160, m_px=0.5):
    clon, clat = 21.0, 52.2
    half = side * m_px / 2
    bbox = (clon - half * M2LON, clat - half * M2LAT, clon + half * M2LON,
            clat + half * M2LAT)
    img = JF.FakeWorld(**WORLD).render(bbox, side, side)
    tif = str(tmp_path / "scene.tif")
    jax_write_geotiff(tif, img, (bbox[0], m_px * M2LON, 0.0, bbox[3], 0.0,
                                 -m_px * M2LAT), 4326)
    return tif


def test_geotiff_on_the_cpu(tmp_path, capsys):
    tif = _raster(tmp_path, side=1280, m_px=0.25)
    out = str(tmp_path / "dets.geojson")
    assert PC.main(["geotiff", tif, "--model", "yolov7_itcvd", "--params",
                    FIXTURE, "--window", "1280", "--stride", "1280",
                    "--confidence", "0.3", "--out", out,
                    "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    doc = read_geojson(out)
    assert line == {"detections": len(doc["features"]), "output": out}
    assert line["detections"] >= 10
    assert doc["metadata"] == {"epsg": 4326, "window": 1280, "stride": 1280}


def test_predict_on_the_cpu(tmp_path, capsys):
    from test_predict_val import WORLD as PRED_WORLD, _bbox, _dense_center
    p = str(tmp_path / "t.png")
    Image.fromarray(PRED_WORLD.render(_bbox(*_dense_center()), 96, 96)) \
        .save(p)
    ann = str(tmp_path / "ann")
    assert PC.main(["predict", p, "--params", FIXTURE, "--imgsz", "96",
                    "--confidence", "0.4", "--annotate", ann,
                    "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["images"][0]["path"] == p
    dets = out["images"][0]["detections"]
    assert len(dets) >= 3 and all(d["label"] == "car" for d in dets)
    assert os.path.exists(os.path.join(ann, "t.png"))


def test_calibrate_equals_jax(tmp_path, capsys):
    tif = _raster(tmp_path)
    out_p, out_j = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    args = [tif, "--model", "yolov7_itcvd", "--params", FIXTURE,
            "--window", "64", "--max-windows", "8"]
    assert PC.main(["calibrate"] + args + ["--out", out_p,
                                           "--device", "cpu"]) == 0
    line_p = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JC.main(["calibrate"] + args + ["--out", out_j]) == 0
    line_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line_p["windows"] == line_j["windows"] == 8
    got, want = json.load(open(out_p)), json.load(open(out_j))
    assert len(got) >= 50 and set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)


XUNET = os.path.join(ROOT, "tests", "fixtures", "xunet_fakeworld.npz")
BUILDINGS = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                 n_cars=150, n_buildings=120, seed=4)


def _building_raster(tmp_path, side=512):
    """The buildings' training world at 0.25 m/px around its centre."""
    half = side * 0.125
    bbox = (21.0 - half * M2LON, 52.2 - half * M2LAT, 21.0 + half * M2LON,
            52.2 + half * M2LAT)
    img = JF.FakeWorld(**BUILDINGS).render(bbox, side, side)
    tif = str(tmp_path / "buildings.tif")
    jax_write_geotiff(tif, img, (bbox[0], 0.25 * M2LON, 0.0, bbox[3], 0.0,
                                 -0.25 * M2LAT), 4326)
    return tif


def test_automask_on_the_cpu_equals_jax_cli(tmp_path, capsys):
    """``automask`` with ``--device cpu`` over a 512-px raster (2×2
    windows, the verbs' bf16 XUnet) beside the JAX verb: instance counts
    within one, instance masks at IoU >= 0.98; and the verb's GeoPackage
    equals an in-process ``automask_geotiff`` of the same arguments."""
    from aerial_image_recognition_tpu_torch.gio.geopackage import read_gpkg
    from aerial_image_recognition_tpu_torch.gio.geotiff import read_geotiff
    from aerial_image_recognition_tpu_torch.pipeline.automask import (
        automask_geotiff)
    tif = _building_raster(tmp_path)
    args = [tif, "--params", XUNET, "--min-area", "100"]
    out = {}
    for pkg, main, extra in (("port", PC.main, ["--device", "cpu"]),
                             ("jax", JC.main, [])):
        assert main(["automask"] + args + [
            "--out-mask", str(tmp_path / f"{pkg}.tif"),
            "--out-polygons", str(tmp_path / f"{pkg}.gpkg")] + extra) == 0
        out[pkg] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])["instances"]
    assert out["jax"] >= 3 and abs(out["port"] - out["jax"]) <= 1
    masks = [read_geotiff(str(tmp_path / f"{p}.tif")).data.reshape(512, 512)
             > 0 for p in ("port", "jax")]
    assert (masks[0] & masks[1]).sum() / (masks[0] | masks[1]).sum() >= 0.98
    inst = automask_geotiff(tif, params=XUNET, min_area_px=100,
                            output_polygons=str(tmp_path / "lib.gpkg"),
                            device="cpu")
    assert len(inst) == out["port"]
    assert read_gpkg(str(tmp_path / "lib.gpkg")) == read_gpkg(
        str(tmp_path / "port.gpkg"))


def test_serve_segment_as_a_process(tmp_path):
    """``serve --segment-params --device cpu`` answers ``/segment`` with the
    mask of an in-process ``make_segment_fn`` over the same bf16 XUnet at
    the same threshold, says so in ``/healthz``, and exits 0 on SIGINT."""
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        make_segment_fn)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    img = JF.FakeWorld(**BUILDINGS).render(
        (21.0 - 32 * M2LON, 52.2 - 32 * M2LAT, 21.0 + 32 * M2LON,
         52.2 + 32 * M2LAT), 256, 256)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    err = open(tmp_path / "serve.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aerial_image_recognition_tpu_torch", "serve",
         "--port", "0", "--params", FIXTURE, "--batch", "1",
         "--segment-params", XUNET, "--segment-batch", "2",
         "--max-wait-ms", "5", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, **CHILD_THREADS),
        stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        with urllib.request.urlopen(line["serving"] + "/healthz",
                                    timeout=60) as r:
            assert json.load(r)["segment"] is True
        req = urllib.request.Request(
            f"{line['serving']}/segment?threshold=0.5",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.load(r)
        mask = np.asarray(Image.open(io.BytesIO(
            base64.b64decode(body["mask_png"])))) > 127
        bundle = create_model("xunet_256", params_path=XUNET, device="cpu",
                              fold_bn=True)
        probs = make_segment_fn(bundle, DetectorConfig(
            model_family="xunet"))(np.stack([img, img]))[0, ..., 0]
        want = probs.numpy() >= 0.5
        assert body["shape"] == [256, 256] and want.mean() >= 0.03
        np.testing.assert_array_equal(mask, want)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=120) == 0, (tmp_path / "serve.err") \
            .read_text()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


def test_calibrate_xunet_equals_jax(tmp_path, capsys):
    """``calibrate --model xunet_256`` over two 256-px windows of the
    buildings' world: the JAX verb's absmax at every ConvBN output within
    rtol 1e-5 (BN folded here, not there)."""
    tif = _building_raster(tmp_path)
    out_p, out_j = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    args = [tif, "--model", "xunet_256", "--params", XUNET, "--window",
            "256", "--max-windows", "2"]
    assert PC.main(["calibrate"] + args + ["--out", out_p,
                                           "--device", "cpu"]) == 0
    assert JC.main(["calibrate"] + args + ["--out", out_j]) == 0
    got, want = json.load(open(out_p)), json.load(open(out_j))
    assert len(got) == 22 and set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)


# ------------------------------------------------------ weights in, out

def _fixture_onnx(path):
    """The fixture as a reference-format blob, written by the JAX
    package's export route."""
    import jax
    f32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                 jax_load_params(FIXTURE))
    write_minimal_onnx(path, jax_torch_state(f32, "yolov7_itcvd"))


def test_import_weights_equals_jax(tmp_path, capsys):
    blob = str(tmp_path / "itcvd.onnx")
    _fixture_onnx(blob)
    out_p, out_j = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    assert PC.main(["import-weights", blob, "--model", "yolov7_itcvd",
                    "--out", out_p, "--device", "cpu"]) == 0
    assert JC.main(["import-weights", blob, "--model", "yolov7_itcvd",
                    "--out", out_j]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["initializers"] == \
        json.loads(lines[1])["initializers"] == len(
            load_onnx_initializers(blob))
    with np.load(out_p) as p, np.load(out_j) as j:
        assert list(p.keys()) == list(j.keys())
        for k in j.keys():
            assert p[k].dtype == j[k].dtype
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    # both packages load it, and the port's model carries its weights
    assert _flat(load_params(out_p)).keys() == _flat(
        {c: dict(v) for c, v in jax_load_params(out_p).items()}).keys()
    jax_create_model("yolov7_itcvd", params_path=out_p)
    bundle = create_model("yolov7_itcvd", params_path=out_p,
                          dtype=torch.float32, device="cpu")
    want = _flat(load_params(FIXTURE))
    for k, v in _flat(bundle.variables).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # a blob of another model is refused with the shape report
    with pytest.raises(ValueError, match="inconsistencies"):
        PC.main(["import-weights", _other_blob(tmp_path), "--model",
                 "yolov7_itcvd", "--out", out_p, "--device", "cpu"])


def test_save_params_writes_the_jax_layout(tmp_path):
    """The same keys, dtypes and bits as the JAX package's ``save_params``
    for a tree with f32 and bf16 leaves (bf16 as uint16 under ``:bf16``),
    and each package reads the other's file."""
    import jax.numpy as jnp
    from aerial_image_recognition_tpu.models.registry import (
        save_params as jax_save_params)
    rng = np.random.default_rng(9)
    w = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    port_tree = {"params": {"stem": {"conv": {
        "kernel": torch.from_numpy(w).to(torch.bfloat16)}, "bias": b}},
        "batch_stats": {"stem": {"mean": b}}}
    jax_tree = {"params": {"stem": {"conv": {
        "kernel": jnp.asarray(w, jnp.bfloat16)}, "bias": jnp.asarray(b)}},
        "batch_stats": {"stem": {"mean": jnp.asarray(b)}}}
    pp, pj = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    save_params(port_tree, pp)
    jax_save_params(jax_tree, pj)
    with np.load(pp) as p, np.load(pj) as j:
        assert list(p.keys()) == list(j.keys()) == [
            "batch_stats/stem/mean", "params/stem/bias",
            "params/stem/conv/kernel:bf16"]
        for k in j.keys():
            assert p[k].dtype == j[k].dtype
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    for path in (pp, pj):
        np.testing.assert_array_equal(
            load_params(path)["params"]["stem"]["conv"]["kernel"],
            np.asarray(jax_load_params(path)["params"]["stem"]["conv"]
                       ["kernel"], np.float32))


def _other_blob(tmp_path):
    """The fixture's blob with one trunk conv cut to half its outputs."""
    sd = load_onnx_initializers(str(tmp_path / "itcvd.onnx"))
    key = next(k for k in sd if k.endswith(".conv.weight"))
    sd[key] = sd[key][: sd[key].shape[0] // 2]
    path = str(tmp_path / "other.onnx")
    write_minimal_onnx(path, sd)
    return path


def test_export_bytes_equal_jax(tmp_path, capsys):
    out_p, out_j = str(tmp_path / "p.onnx"), str(tmp_path / "j.onnx")
    assert PC.main(["export", FIXTURE, out_p, "--model", "yolov7_itcvd",
                    "--device", "cpu"]) == 0
    assert JC.main(["export", FIXTURE, out_j, "--model", "yolov7_itcvd"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["tensors"] == json.loads(lines[1])["tensors"]
    with open(out_p, "rb") as f, open(out_j, "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------- serve, doctor

def test_serve_as_a_process(tmp_path):
    """``serve --device cpu`` prints its address, answers a JPEG POST with
    records and class names, and SIGINT ends it with exit 0."""
    err = open(tmp_path / "serve.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aerial_image_recognition_tpu_torch", "serve",
         "--port", "0", "--params", FIXTURE, "--batch", "2",
         "--max-wait-ms", "5", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, **CHILD_THREADS),
        stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        assert line["model"] == "yolov7_itcvd"
        lon, lat = 21.0, 52.2
        half = 160.0
        bbox = (lon - half * M2LON, lat - half * M2LAT, lon + half * M2LON,
                lat + half * M2LAT)
        img = PF.FakeWorld(**WORLD).render(bbox, 640, 640)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=95)
        q = "&".join(f"{k}={v}" for k, v in zip(
            ("west", "south", "east", "north"), bbox))
        req = urllib.request.Request(f"{line['serving']}/detect?{q}",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.load(r)
        assert body["count"] == len(body["detections"]) >= 5
        assert {d["class"] for d in body["detections"]} == {"car"}
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=120) == 0, (tmp_path / "serve.err") \
            .read_text()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


def test_doctor_without_cuda(capsys):
    d = doctor.diagnose(compile_check=False)
    assert d["torch_version"] == torch.__version__
    assert d["devices"] == [] and d["backend"] == "cpu"
    assert set(d["kernels_built"]) == set(doctor.KERNELS)
    assert all(v is True or isinstance(v, str)
               for v in d["kernels_built"].values())
    assert isinstance(d["native_fastgeo"], bool) and d["fetch_plane"] is True
    assert PC.main(["doctor"]) == 0
    assert "torch_version" in json.loads(capsys.readouterr().out)


def test_doctor_device_probe_times_out():
    import time

    class Hanging:
        class cuda:
            @staticmethod
            def is_available():
                time.sleep(30)

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="wedged"):
        doctor._devices_with_timeout(Hanging, 0.5)
    assert time.perf_counter() - t0 < 5

    class Healthy:
        class cuda:
            is_available = staticmethod(lambda: True)
            device_count = staticmethod(lambda: 2)
            get_device_name = staticmethod(lambda i: f"card{i}")

    assert doctor._devices_with_timeout(Healthy, 5.0) == ["card0", "card1"]


# ---------------------------------------------------------- train, val

@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """12 FakeWorld tiles of 96 px (48 m at 0.5 m/px) as PNGs and their
    exact car boxes as a COCO json."""
    from test_predict_val import WORLD as PRED_WORLD, _bbox, _gt_boxes_xyxy
    base = tmp_path_factory.mktemp("coco")
    imdir = base / "images"
    imdir.mkdir()
    rng = np.random.default_rng(11)
    images, anns = [], []
    for i in range(12):
        lon, lat, _ = PRED_WORLD.cars[int(rng.integers(0, 400))]
        bbox = _bbox(float(lon) + float(rng.uniform(-1e-4, 1e-4)),
                     float(lat) + float(rng.uniform(-1e-4, 1e-4)))
        Image.fromarray(PRED_WORLD.render(bbox, 96, 96)).save(
            str(imdir / f"t{i}.png"))
        images.append({"id": i, "file_name": f"t{i}.png", "width": 96,
                       "height": 96})
        for x1, y1, x2, y2 in _gt_boxes_xyxy(bbox, 96):
            anns.append({"id": len(anns), "image_id": i, "category_id": 0,
                         "bbox": [float(x1), float(y1), float(x2 - x1),
                                  float(y2 - y1)]})
    assert len(anns) >= 12
    coco = str(base / "coco.json")
    with open(coco, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 0, "name": "car"}]}, f)
    return coco, str(imdir), base


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_and_val_on_the_cpu_equal_jax_cli(coco_set, capsys):
    coco, imdir, base = coco_set
    lr, epochs = 1e-4, 2
    argv = ["train", "--coco", coco, "--images", imdir, "--model",
            "yolov7_itcvd", "--params", FIXTURE, "--imgsz", "96", "--batch",
            "4", "--epochs", str(epochs), "--n-train", "8", "--lr", str(lr),
            "--freeze", "0,1,2"]
    jout = str(base / "jax.npz")
    pout = str(base / "port.npz")
    assert JC.main(argv + ["--out", jout]) == 0
    want = _last_json(capsys)
    assert PC.main(argv + ["--out", pout, "--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert got["checkpoint"] == pout
    assert got["final"]["epoch"] == want["final"]["epoch"] == epochs - 1
    np.testing.assert_allclose(got["final"]["loss"], want["final"]["loss"],
                               rtol=1e-3)
    assert abs(got["final"]["mAP50"] - want["final"]["mAP50"]) <= 0.02
    assert got["final"]["mAP50"] >= 0.7
    assert got["best"]["epoch"] == want["best"]["epoch"]
    # each checkpoint loads in both packages: the same leaves and shapes
    steps = epochs * 2
    fixture = _flat(load_params(FIXTURE))
    for path in (jout, pout):
        a, b = _flat(load_params(path)), _flat(jax_load_params(path))
        assert a.keys() == b.keys() == fixture.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k], np.float32))
    j, p = _flat(load_params(jout)), _flat(load_params(pout))
    for k in j:
        np.testing.assert_allclose(p[k], j[k], rtol=0,
                                   atol=4 * lr * steps + 1e-6, err_msg=k)
        if k.split("/")[1] in ("stem0", "stem1") or \
                k.split("/")[1:3] == ["elan1", "cv1"]:
            np.testing.assert_array_equal(p[k], fixture[k], err_msg=k)

    # val of the port's checkpoint against the JAX verb's
    vargv = ["val", "--coco", coco, "--images", imdir, "--model",
             "yolov7_itcvd", "--params", pout, "--imgsz", "96", "--batch",
             "4"]
    assert JC.main(vargv) == 0
    want = _last_json(capsys)
    assert PC.main(vargv + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert got["n_images"] == want["n_images"] == 12
    assert got.keys() == want.keys()
    for k in ("mAP50", "mAP50_95", "AP50_class0"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


@pytest.mark.parametrize("verb", ["train", "val"])
def test_train_and_val_without_a_device_exit_before_reading(verb,
                                                            monkeypatch,
                                                            tmp_path):
    """Without --device and without CUDA the verb raises the device error
    before it reads the COCO file (which does not exist here)."""
    argv = [verb, "--coco", str(tmp_path / "missing.json"), "--images",
            str(tmp_path)] + (["--out", str(tmp_path / "o.npz")]
                              if verb == "train" else [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PC.main(argv)
    with pytest.raises(FileNotFoundError):
        PC.main(argv + ["--device", "cpu"])
