"""RT-DETR (``models/rtdetr.py``) on the CPU, at a small size: a 128-px
input, narrow widths, 2 decoder layers and 20 queries, on seeded weights
calibrated as the benchmark's configuration says.

Held against the benchmark's plain reference (``benchmark/reference/
families/rtdetr-r50vd.py``: f32, BN unfolded, both RepVGG branches, the
deformable sampling by ``grid_sample``), which in turn is held against
``transformers``' ``RTDetrForObjectDetection`` where that package imports,
its random weights carried over by ``models/import_torch.
rtdetr_from_transformers``. Also: the plain deformable sampling against the
reference's ``grid_sample`` form, the NMS-free finish, a whole
``CarDetector`` scan against the reference's records, the profiler spans,
and the registry entry at the published widths.

Tolerances, f32 throughout: the two sides sum in other orders (cuDNN-free
CPU convolutions alike, but ``scaled_dot_product_attention`` against two
matrix products, the BN and RepVGG folds, bilinear weights by floor against
``grid_sample``'s unnormalised grid), a few f32 ulps of a unit-scale value
that the decoder's layers carry on; 1e-4 of the largest magnitude covers
them with room, and a wrong layer moves the outputs by a unit.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu_torch.models.registry import (
    ModelBundle, ModelSpec, REGISTRY, create_model, resolve_model_name)
from aerial_image_recognition_tpu_torch.models.rtdetr import RTDETR
from aerial_image_recognition_tpu_torch.ops.ms_deform_attn import (
    ms_deform_attn, ms_deform_attn_plain)
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    _set_prediction_finish, build_detect_step)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from benchmark.lib import registry as bench_registry
from benchmark.lib import tiles as bench_tiles
from benchmark.lib import weights as bench_weights
from benchmark.reference import post as ref_post

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128
SMALL = dict(backbone_embedding_size=16, backbone_hidden_sizes=[32, 64, 96, 128],
             backbone_depths=[1, 1, 2, 1], encoder_hidden_dim=32,
             encoder_in_channels=[64, 96, 128], encoder_ffn_dim=64,
             encoder_attention_heads=2, d_model=32, num_queries=20,
             decoder_in_channels=[32, 32, 32], decoder_ffn_dim=64,
             decoder_layers=2, decoder_attention_heads=2, input_size=SIZE)

torch.set_num_threads(2)


def _config(**over):
    """The benchmark's configuration at the small widths; a quarter of the
    20 queries clear the threshold (4 % of 300 there)."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "rtdetr-r50vd.json")) as f:
        cfg = json.load(f)
    cfg.update(SMALL)
    cfg["weights"] = dict(cfg["weights"], class_share_above=0.25)
    cfg.update(over)
    return cfg


def _port_kwargs(cfg):
    """The module's widths of a configuration."""
    return dict(embedding_size=cfg["backbone_embedding_size"],
                hidden_sizes=tuple(cfg["backbone_hidden_sizes"]),
                depths=tuple(cfg["backbone_depths"]),
                hidden_dim=cfg["encoder_hidden_dim"],
                encoder_heads=cfg["encoder_attention_heads"],
                encoder_ffn_dim=cfg["encoder_ffn_dim"],
                d_model=cfg["d_model"], num_queries=cfg["num_queries"],
                decoder_layers=cfg["decoder_layers"],
                decoder_heads=cfg["decoder_attention_heads"],
                decoder_ffn_dim=cfg["decoder_ffn_dim"],
                points=cfg["decoder_n_points"])


def _spec(cfg):
    """The registry's rtdetr_r50vd slot at the configuration's widths."""
    return ModelSpec("rtdetr_r50vd", "rtdetr", cfg["nc"], cfg["input_size"],
                     lambda: RTDETR(cfg["nc"], **_port_kwargs(cfg)),
                     tuple(cfg["class_names"]))


@pytest.fixture
def small_registry(monkeypatch):
    """``create_model("rtdetr_r50vd")`` builds the small model."""
    cfg = _config()
    monkeypatch.setitem(REGISTRY, "rtdetr_r50vd", _spec(cfg))
    return cfg


@pytest.fixture(scope="module")
def seeded():
    """(config, reference family, flat f32 weights, nested tree, images
    [4,3,S,S] f32 in [0,1]) on seeded, calibrated weights."""
    cfg = _config()
    family = bench_registry.family(cfg["reference"])
    pool, _ = bench_tiles.render_tiles(np.random.default_rng(7), 4, SIZE)
    flat, tree = bench_weights.make(cfg, family, 2200000001,
                                    torch.device("cpu"), ROOT, pool)
    x = torch.from_numpy(pool).permute(0, 3, 1, 2).float() / 255.0
    return cfg, family, flat, tree, x


def _close(a, b, rel=1e-4):
    scale = max(float(b.abs().max()), 1e-6)
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= rel * scale, \
        float((a - b).abs().max()) / scale


@pytest.mark.parametrize("fold", [False, True])
def test_port_matches_reference_f32(seeded, fold):
    """Encoder scores over every token, the selected queries, the final
    logits and boxes: the port (unfolded, and with BN and the RepVGG
    branches folded as the detect step runs it) against the reference."""
    cfg, family, flat, tree, x = seeded
    with torch.no_grad():
        ref = family.forward(cfg, flat, x)
    module = RTDETR(cfg["nc"], **_port_kwargs(cfg)).eval()
    from aerial_image_recognition_tpu_torch.models.layers import (
        fold_batchnorm)
    from aerial_image_recognition_tpu_torch.models.weights import (
        load_flax_into)
    load_flax_into(module, tree)
    if fold:
        fold_batchnorm(module)
        assert not any(m.c1 is not None for m in module.modules()
                       if hasattr(m, "reparameterize"))
    with torch.no_grad():
        got = module(x)
    _close(got["enc_scores"], ref["enc_scores"])
    assert torch.equal(got["topk"], ref["topk"])
    _close(got["logits"], ref["logits"])
    _close(got["boxes"], ref["boxes"])
    # the calibration's aims on its own tiles: the best class of queries
    # of every tile clears 0.3, the encoder's five worst selected queries
    # do not (at 300 of 8400 tokens they stay below 0.2 too; 20 of 336
    # lie closer together)
    best = torch.sigmoid(ref["logits"]).amax(-1)
    assert bool((best > 0.3).any(1).all())
    assert float(best[:, -5:].max()) < 0.3


def _module(cfg, tree, fold, **over):
    """The port at the configuration's widths (``over`` on top), holding
    the seeded weights, BN and RepVGG folded or not."""
    from aerial_image_recognition_tpu_torch.models.layers import (
        fold_batchnorm)
    from aerial_image_recognition_tpu_torch.models.weights import (
        load_flax_into)
    module = RTDETR(cfg["nc"], **dict(_port_kwargs(cfg), **over)).eval()
    load_flax_into(module, tree)
    if fold:
        fold_batchnorm(module)
    return module


def _whole_token(dec, feats):
    """The decoder with its select in the whole-token form: ``dec``'s own
    box head over every token, the anchor logits added, then the top-k
    rows gathered; then ``dec``'s layers as ``Decoder.forward`` runs them.
    The select's ``ref`` and ``h`` come out beside the outputs."""
    from aerial_image_recognition_tpu_torch.models.rtdetr import (
        inverse_sigmoid)
    shapes = [(int(f.shape[2]), int(f.shape[3])) for f in feats]
    memory = torch.cat([dec._project(i, f) for i, f in enumerate(feats)], 1)
    anc, valid = dec._anchors_for(shapes, memory.device)
    om = dec.enc_norm(dec.enc_output(memory * valid))
    enc_scores = dec.enc_score(om)
    enc_boxes = dec.enc_bbox(om) + anc
    top = torch.topk(enc_scores.max(-1).values, dec.queries, dim=1).indices
    ref = torch.sigmoid(enc_boxes.gather(1, top[..., None].expand(-1, -1,
                                                                  4)))
    h = om.gather(1, top[..., None].expand(-1, -1, om.shape[-1]))
    out = {"enc_scores": enc_scores, "topk": top, "ref": ref, "h": h}
    for i in range(dec.layers):
        pos = dec.query_pos(ref)
        h = getattr(dec, f"layer{i}")(h, pos, ref, memory, shapes)
        ref = torch.sigmoid(getattr(dec, f"bbox{i}")(h)
                            + inverse_sigmoid(ref))
    out["logits"] = getattr(dec, f"class{dec.layers - 1}")(h)
    out["boxes"] = ref
    return out


def _selected_form(dec, feats):
    """``dec(feats)``, with the select's ``h`` (the box head's input) and
    ``ref`` (the first layer's boxes) caught by hooks."""
    seen = {}

    def keep(name):
        def hook(module, args, *out):
            seen.setdefault(name, args[0])
        return hook
    hooks = [dec.enc_bbox.register_forward_hook(keep("h")),
             dec.query_pos.register_forward_pre_hook(keep("ref"))]
    try:
        out = dec(feats)
    finally:
        for hook in hooks:
            hook.remove()
    return dict(out, **seen)


def _assert_same_bits(got, want):
    """Tolerance 0: each selected row meets the same Linear layers and the
    same anchor add on the same f32 input row in both forms, and the CPU
    sums a row of a matrix product in one order whatever the row count."""
    for k in ("enc_scores", "topk", "h", "ref", "logits", "boxes"):
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), \
            (k, float((got[k].double() - want[k].double()).abs().max()))


@pytest.mark.parametrize("fold", [False, True])
def test_select_runs_the_box_head_on_the_chosen_rows(seeded, fold):
    """The box head sees the Q chosen rows of each tile and not all L
    tokens, and the select's ``topk``, ``ref`` and ``h`` and the forward's
    ``logits`` and ``boxes`` are the whole-token form's bits."""
    cfg, _, _, tree, x = seeded
    module = _module(cfg, tree, fold)
    with torch.no_grad():
        feats = module.encoder(module.backbone(x))
        got = _selected_form(module.decoder, feats)
        want = _whole_token(module.decoder, feats)
        whole = module(x)
    assert got["h"].shape == (x.shape[0], cfg["num_queries"],
                              cfg["d_model"])
    _assert_same_bits(got, want)
    for k in ("enc_scores", "topk", "logits", "boxes"):
        assert torch.equal(whole[k], got[k]), k


@pytest.mark.parametrize("fold", [False, True])
def test_select_of_border_tokens_reads_their_invalid_anchors(seeded, fold):
    """At 416 px the stride-8 level is 52 × 52, so its outer ring of
    cells lies within 1 % of the border and its anchors are invalid (f32's
    largest value). With ``num_queries`` every token, those rows are
    selected too: their first boxes are the sigmoid of that value, 1.0,
    and the select and the outputs are the whole-token form's bits."""
    cfg, _, _, tree, _ = seeded
    size = 416
    tokens = sum((size // s) ** 2 for s in (8, 16, 32))
    module = _module(cfg, tree, fold, num_queries=tokens)
    x = torch.rand(2, 3, size, size, generator=torch.Generator()
                   .manual_seed(416))
    with torch.no_grad():
        feats = module.encoder(module.backbone(x))
        got = _selected_form(module.decoder, feats)
        want = _whole_token(module.decoder, feats)
    _, valid = module.decoder._anchors_for(
        [tuple(f.shape[2:]) for f in feats], x.device)
    border = ~valid[0, :, 0][got["topk"]]
    assert int(border.sum()) == 2 * 4 * (52 - 1)
    assert bool((got["ref"][border] == 1.0).all())
    assert bool((got["ref"][~border] < 1.0).all())
    _assert_same_bits(got, want)


def test_enc_box_rows_counts_b_times_q_a_forward(seeded):
    """``Decoder.enc_box_rows`` adds B × Q each forward: the rows the
    encoder's box head ran on."""
    from aerial_image_recognition_tpu_torch.models.rtdetr import Decoder
    cfg, _, _, tree, x = seeded
    module = _module(cfg, tree, True)
    before = Decoder.enc_box_rows
    with torch.no_grad():
        module(x)
        assert Decoder.enc_box_rows - before == x.shape[0] * 20
        module(x[:1])
    assert Decoder.enc_box_rows - before == (x.shape[0] + 1) * 20
    assert "enc_box_rows" not in vars(module.decoder)


def _sampling_case(seed):
    """value, shapes, locations (inside, outside [0,1] and on cell
    borders) and softmaxed weights."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(6, 8), (3, 4), (2, 2)]
    b, q, heads, d, points = 2, 5, 2, 4, 3
    value = torch.randn(b, sum(h * w for h, w in shapes), heads, d,
                        generator=g)
    loc = torch.rand(b, q, heads, len(shapes), points, 2, generator=g) \
        * 1.4 - 0.2
    # exact cell borders and centres of each level, and the map's edges
    for lvl, (h, w) in enumerate(shapes):
        loc[0, 0, 0, lvl, 0] = torch.tensor([1.0 / w, 2.0 / h])
        loc[0, 0, 1, lvl, 1] = torch.tensor([0.5 / w, 0.5 / h])
        loc[1, 1, 0, lvl, 2] = torch.tensor([0.0, 1.0])
        loc[1, 2, 1, lvl, 0] = torch.tensor([1.0, 0.0])
    weights = torch.softmax(torch.randn(b, q, heads, len(shapes) * points,
                                        generator=g), -1) \
        .view(b, q, heads, len(shapes), points)
    return value, shapes, loc, weights


@pytest.mark.parametrize("level", [0, 1, 2, None])
def test_plain_sampling_matches_grid_sample(seeded, level, monkeypatch):
    """The plain version (what the CPU wrapper runs, and never the
    kernel's build) against the reference's grid_sample form, one level at
    a time and all three: equal to f32 rounding (1e-6: the bilinear
    weights come from floor here and from grid_sample's unnormalised grid
    there)."""
    from aerial_image_recognition_tpu_torch.kernels import build

    def no_build(*a, **kw):
        raise AssertionError("the CPU path reached kernels.build")
    for name in ("load", "build_all", "_start", "_nvcc"):
        monkeypatch.setattr(build, name, no_build)
    family = seeded[1]
    value, shapes, loc, weights = _sampling_case(3)
    if level is not None:
        keep = torch.zeros(len(shapes))
        keep[level] = 1.0
        weights = weights * keep[None, None, None, :, None]
    before = ms_deform_attn.launches
    got = ms_deform_attn(value, shapes, loc, weights)
    assert ms_deform_attn.launches == before
    want = family.sample(value, shapes, loc, weights)
    assert got.shape == (2, 5, 8)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(
        ms_deform_attn_plain(value, shapes, loc, weights), got)


def test_plain_sampling_outside_reads_zero():
    value, shapes, loc, weights = _sampling_case(4)
    far = torch.full_like(loc, 7.0)
    assert float(ms_deform_attn_plain(value, shapes, far, weights)
                 .abs().max()) == 0.0


@pytest.mark.parametrize("slots, threshold", [(4, 0.3), (16, 0.3),
                                              (16, 0.0), (3, 0.95)])
def test_set_prediction_finish(slots, threshold):
    """Top ``max_detections_per_tile`` over query x class, kept above the
    threshold (strictly, as the published post-process), padded with
    invalid slots when there are fewer candidates than slots."""
    g = torch.Generator().manual_seed(5)
    b, q, nc = 2, 5, 2
    scores = torch.rand(b, q, nc, generator=g)
    boxes = torch.rand(b, q, 4, generator=g) * 100
    scores[0, 3, 1] = 0.3                       # at the threshold: out
    cfg = DetectorConfig(max_detections_per_tile=slots,
                         confidence_threshold=threshold)
    det = _set_prediction_finish(boxes, scores, cfg)
    assert det.boxes.shape == (b, slots, 4) and det.valid.shape == (b, slots)
    for r in range(b):
        flat = [(float(scores[r, i, c]), i, c) for i in range(q)
                for c in range(nc)]
        flat.sort(key=lambda t: -t[0])
        # compared in f32, as the step compares
        want = [t for t in flat[:slots] if np.float32(t[0])
                > np.float32(threshold)]
        n = int(det.valid[r].sum())
        assert n == len(want)
        assert bool(det.valid[r, :n].all()) and not bool(det.valid[r, n:]
                                                         .any())
        for k, (s, i, c) in enumerate(want):
            assert float(det.scores[r, k]) == s
            assert int(det.classes[r, k]) == c
            assert torch.equal(det.boxes[r, k], boxes[r, i])
        assert float(det.scores[r, n:].abs().sum()) == 0.0
        assert bool((det.classes[r, n:] == -1).all())


def test_step_matches_reference_answer(seeded, small_registry):
    """The f32 detect step (preprocess, model, finish, lon/lat) over
    uint8 tiles against the reference's answer on the same tiles."""
    cfg, family, flat, tree, x = seeded
    bundle = create_model("rtdetr_r50vd", variables=tree,
                          dtype=torch.float32, device="cpu", fold_bn=True)
    step = build_detect_step(DetectorConfig(
        model_path="rtdetr_r50vd", model_family="rtdetr", num_classes=2,
        dtype="float32", confidence_threshold=0.3,
        max_detections_per_tile=32), bundle=bundle, batch=4,
        model_size=SIZE, device="cpu")
    assert step.input_layout == "hwc"
    u8 = (x * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).numpy()
    bounds = np.tile(np.float32([[21.0, 52.2, 21.001, 52.201]]), (4, 1))
    det, lon, lat = step(u8, bounds)
    kept = family.answer(cfg, flat, torch.from_numpy(u8).permute(0, 3, 1, 2)
                         .float() / 255.0, conf=0.3, iou_thr=0.45,
                         max_det=32, pre_topk=0)
    for r, (box, score, cls) in enumerate(kept):
        n = int(det.valid[r].sum())
        assert n == len(score) > 0
        np.testing.assert_allclose(det.boxes[r, :n].numpy(), box,
                                   atol=1e-3)
        np.testing.assert_allclose(det.scores[r, :n].numpy(), score,
                                   atol=1e-5)
        assert det.classes[r, :n].tolist() == cls.tolist()


class _Capture:
    """The step, keeping a host copy of every batch it is handed."""

    def __init__(self, step):
        self.step = step
        self.batches = []

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, images, bounds):
        def host(t):
            if isinstance(t, (list, tuple)):
                return torch.cat([torch.as_tensor(np.asarray(u)) for u in t])
            return torch.as_tensor(np.asarray(t)).clone()
        self.batches.append((host(images), host(bounds).double()))
        return self.step(images, bounds)


def test_scan_records_match_reference(seeded, small_registry, tmp_path):
    """A whole ``CarDetector`` WMS scan with ``rtdetr_r50vd`` (the small
    model, f32) against the records the reference makes of the tiles the
    scan's step was handed: its answer, lon/lat and the 1-m dedup, over
    the tiles of the scan's coverage layer."""
    from aerial_image_recognition_tpu_torch.fetch import fake as PF
    from aerial_image_recognition_tpu_torch.gio.geojson import (
        read_geojson, write_geojson)
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    cfg, family, flat, tree, _ = seeded
    srv = PF.FakeTileServer(PF.FakeWorld(center_lon=21.0, center_lat=52.2,
                                         extent_deg=0.004, n_cars=60,
                                         seed=11))
    srv.start()
    try:
        frame = str(tmp_path / "aoi.geojson")
        write_geojson({"type": "FeatureCollection", "features": [{
            "type": "Feature", "properties": {}, "geometry": {
                "type": "Polygon", "coordinates": [[
                    [20.9985, 52.1988], [21.0015, 52.1988],
                    [21.0015, 52.2012], [20.9985, 52.2012],
                    [20.9985, 52.1988]]]}}]}, frame)
        conf = {"frame_path": frame, "batch_size": 8, "device_batch": 8,
                "num_workers": 4, "duplicate_distance": 1.0,
                "checkpoint_interval": 10**9, "confidence_threshold": 0.3,
                "use_xyz": False, "wms_url": srv.base_url + "/wms",
                "wms_layer": "fake", "wms_size": (SIZE, SIZE),
                "tile_size_meters": 64.0, "tile_overlap": 0.2,
                "submit_spacing": 0.0, "model_path": "rtdetr_r50vd",
                "model_family": "rtdetr", "num_classes": 2,
                "dtype": "float32", "max_detections_per_tile": 32}
        bundle = create_model("rtdetr_r50vd", variables=tree,
                              dtype=torch.float32, device="cpu",
                              fold_bn=True)
        det = CarDetector(str(tmp_path), conf, device="cpu")
        step = _Capture(build_detect_step(
            det._step_config(), bundle=bundle, batch=8, model_size=SIZE,
            device="cpu"))
        out = CarDetector(str(tmp_path), conf,
                          detect_step=step).detect(force_restart=True)
    finally:
        srv.stop()
    assert out["tiles"] > 10
    doc = read_geojson(str(tmp_path / "output" /
                           "detections_results.geojson"))
    cov = read_geojson(str(tmp_path / "output" /
                           "detections_coverage.geojson"))
    tiles = set()
    for f in cov["features"]:
        ring = np.asarray(f["geometry"]["coordinates"][0])
        tiles.add(tuple(np.round([ring[:, 0].min(), ring[:, 1].min(),
                                  ring[:, 0].max(), ring[:, 1].max()], 9)))
    lon_l, lat_l, conf_l, cls_l = [], [], [], []
    seen = 0
    for images, bounds in step.batches:
        x = images.permute(0, 3, 1, 2).float() / 255.0
        kept = family.answer(cfg, flat, x, conf=0.3, iou_thr=0.45,
                             max_det=32, pre_topk=0)
        for (box, score, cls), bb in zip(kept, bounds.numpy()):
            if tuple(np.round(bb, 9)) not in tiles:
                continue                      # a batch's padding row
            seen += 1
            lon, lat = ref_post.lonlat(box[:, :2], bb, SIZE)
            lon_l.append(lon)
            lat_l.append(lat)
            conf_l.append(score)
            cls_l += [cfg["class_names"][c] for c in cls]
    assert seen == out["tiles"] == len(tiles)
    lon, lat, sc = (np.concatenate(v) for v in (lon_l, lat_l, conf_l))
    keep = ref_post.dedup(lon, lat, sc, 1.0)
    want = sorted(zip(lon[keep], lat[keep], sc[keep],
                      np.asarray(cls_l)[keep]))
    got = sorted((f["geometry"]["coordinates"][0],
                  f["geometry"]["coordinates"][1],
                  f["properties"]["confidence"], f["properties"]["class"])
                 for f in doc["features"])
    assert len(got) == len(want) > 10
    assert [g[3] for g in got] == [w[3] for w in want]
    a = np.asarray([g[:3] for g in got], float)
    b = np.asarray([w[:3] for w in want], float)
    # 1e-7 degrees is 1 cm; scores to 1e-4: the two sides' f32 sum-order
    # differences of the logits, a few 1e-5 after the layers
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-7, rtol=0)
    np.testing.assert_allclose(a[:, 2], b[:, 2], atol=1e-4, rtol=0)


def test_spans_show_in_a_profiler_trace(seeded, small_registry):
    """The step's forward and finish are spans of ``Tracer.annotate``:
    ``rtdetr.backbone``, ``.encoder``, ``.select``, ``.decoder`` and
    ``.finish`` in a ``torch.profiler`` trace."""
    from torch.profiler import profile
    cfg, _, _, tree, x = seeded
    step = build_detect_step(DetectorConfig(
        model_path="rtdetr_r50vd", model_family="rtdetr", dtype="float32"),
        bundle=create_model("rtdetr_r50vd", variables=tree,
                            dtype=torch.float32, device="cpu", fold_bn=True),
        batch=2, model_size=SIZE, device="cpu")
    u8 = np.zeros((2, SIZE, SIZE, 3), np.uint8)
    bounds = np.tile(np.float32([[21.0, 52.2, 21.001, 52.201]]), (2, 1))
    with profile() as prof:
        step(u8, bounds)
    names = {e.name for e in prof.events()}
    for span in ("backbone", "encoder", "select", "decoder", "finish"):
        assert f"rtdetr.{span}" in names, span


def test_int8_is_refused_for_the_set_prediction_model(seeded,
                                                      small_registry):
    """RT-DETR ends without NMS (``nms_free``) and has no stem table: the
    int8 step and ``quantize_bundle`` refuse it before any calibration."""
    from aerial_image_recognition_tpu_torch.models.int8 import (
        quantize_bundle)
    bundle = create_model("rtdetr_r50vd", variables=seeded[3],
                          dtype=torch.float32, device="cpu", fold_bn=True)
    assert bundle.module.nms_free and not hasattr(bundle.module,
                                                  "stem_table")
    cfg = DetectorConfig.from_dict({
        "model_path": "rtdetr_r50vd", "model_family": "rtdetr",
        "dtype": "float32", "quantize": "int8"})
    with pytest.raises(NotImplementedError, match="set-prediction model"):
        build_detect_step(cfg, bundle=bundle, batch=2, model_size=SIZE,
                          device="cpu")
    with pytest.raises(NotImplementedError,
                       match="no int8 detector lowering for rtdetr_r50vd"):
        quantize_bundle(bundle, [])


def test_registry_builds_the_published_model():
    """``rtdetr_r50vd`` at the published widths: 42.8 M parameters, the
    decoder f32 under a bf16 trunk, names resolved."""
    for name in ("rtdetr_r50vd", "rtdetr-r50vd.pt", "RT-DETR_r50.onnx"):
        assert resolve_model_name(name) == "rtdetr_r50vd"
    bundle = create_model("rtdetr_r50vd", dtype=torch.bfloat16,
                          device="cpu", fold_bn=True)
    assert isinstance(bundle, ModelBundle) and bundle.spec.family == "rtdetr"
    from aerial_image_recognition_tpu_torch.models.weights import _flatten
    n = sum(np.size(v) for k, v in _flatten(bundle.variables)
            if k[0] == "params")
    assert 42.0e6 < n < 43.0e6
    m = bundle.module
    assert next(m.backbone.parameters()).dtype == torch.bfloat16
    assert next(m.encoder.parameters()).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.decoder.parameters())
    assert not bundle.supports_s2d2()
    assert m.decoder.queries == 300 and m.decoder.layers == 6
    assert math.isclose(m.config["temperature"], 10000.0)


def _into_transformers(model, flat):
    """Copy the flat flax-path weights into ``model`` through the import's
    own name mapping, run backwards leaf by leaf."""
    from aerial_image_recognition_tpu_torch.models.import_torch import (
        rtdetr_from_transformers)
    from aerial_image_recognition_tpu_torch.models.weights import _flatten
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if "denoising" in name or "num_batches_tracked" in name:
                continue
            (path, _), = list(_flatten(rtdetr_from_transformers(
                {name: t.numpy()})))
            src = flat["/".join(path)]
            if path[-2:] == ("conv", "kernel"):
                src = src.permute(3, 2, 0, 1)
            elif path[-1] == "kernel":
                src = src[0, 0].T
            t.copy_(src)


def test_reference_follows_transformers(seeded):
    """The witness that the reference family follows the published
    equations: ``RTDetrForObjectDetection`` at the small configuration,
    holding the seeded weights, against the reference's forward (and the
    port's): encoder scores, the selection, logits and boxes. The weights
    go in and come back out by ``rtdetr_from_transformers``."""
    transformers = pytest.importorskip("transformers")
    cfg, family, flat, tree, x = seeded
    bb = transformers.RTDetrResNetConfig(
        embedding_size=16, hidden_sizes=[32, 64, 96, 128],
        depths=[1, 1, 2, 1], out_features=["stage2", "stage3", "stage4"])
    hcfg = transformers.RTDetrConfig(
        backbone_config=bb, encoder_hidden_dim=32,
        encoder_in_channels=[64, 96, 128], encoder_ffn_dim=64,
        encoder_attention_heads=2, d_model=32, num_queries=20,
        decoder_in_channels=[32, 32, 32], decoder_ffn_dim=64,
        decoder_layers=2, decoder_attention_heads=2, num_labels=2)
    model = transformers.RTDetrForObjectDetection(hcfg).eval()
    _into_transformers(model, flat)
    from aerial_image_recognition_tpu_torch.models.import_torch import (
        rtdetr_from_transformers, variables_from_torch_state)
    from aerial_image_recognition_tpu_torch.models.weights import (
        _flatten, load_flax_into)
    back = {"/".join(k): v for k, v in _flatten(rtdetr_from_transformers(
        model.state_dict()))}
    assert set(back) == set(flat) == set(family.shapes(cfg))
    for k, v in back.items():
        assert np.array_equal(v, flat[k].numpy()), k
    with torch.no_grad():
        hf = model(pixel_values=x)
        ref = family.forward(cfg, flat, x)
        port = RTDETR(2, **_port_kwargs(cfg)).eval()
        load_flax_into(port, tree)
        got = port(x)
    top = torch.topk(hf.enc_outputs_class.max(-1).values, 20, dim=1).indices
    for out in (ref, got):
        _close(out["enc_scores"], hf.enc_outputs_class)
        assert torch.equal(out["topk"], top)
        _close(out["logits"], hf.logits)
        _close(out["boxes"], hf.pred_boxes)
    # the family-dispatching import gives the same tree
    again = variables_from_torch_state(
        {k: v.numpy() for k, v in model.state_dict().items()},
        "rtdetr_r50vd")
    assert {"/".join(k) for k, _ in _flatten(again)} == set(flat)


def test_import_refuses_an_unknown_name():
    from aerial_image_recognition_tpu_torch.models.import_torch import (
        rtdetr_from_transformers)
    with pytest.raises(KeyError, match="no RT-DETR mapping"):
        rtdetr_from_transformers({"model.extra_head.weight":
                                  np.zeros((2, 2), np.float32)})
