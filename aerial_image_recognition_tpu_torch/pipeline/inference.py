"""The fused detection step: uint8 tiles → georeferenced detections.

Counterpart of ``aerial_image_recognition_tpu/pipeline/inference.py``
(``DetectStep``, ``make_detect_fn``, ``use_quad_stem``,
``build_detect_step``, ``detection_sets_agree``). One call runs preprocess
(crop, resize, /255) → trunk (any registry detector) → f32 heads →
decode → NMS (CUDA kernel on the card; class-aware for the two-class
yolov8 models) → lon/lat on the device, so only ~max_det·6 numbers per tile come back to
the host. A set-prediction detector (RT-DETR) ends without NMS: the top
``max_detections_per_tile`` of its queries' class scores above the
threshold (``_set_prediction_finish``). Native-size YOLOv7-tiny and
YOLOv8 tiles take the quad stem by default, as in the reference (``use_quad_stem``; ``extra.quad_stem:
false`` opts out): the step's batches are then in the s2d² layout
(``input_layout == "s2d2"``), whose /255 folds into the stem's first conv
(``ops/quadstem.py``). The accuracy modes — the TTA ladder (whose CLAHE
variations run the CUDA LUT-apply kernel on the card), multiscale, box
voting, shadow enhancement — widen the middle of that chain and leave its
ends as they are.

PyTorch runs eagerly, so there is no compile step: the step is a plain
function over device tensors. ``DetectStep`` keeps the surface that
``CarDetector``, ``run_pipeline`` and the server read (``batch``,
``input_size``, ``model_size``, ``input_layout``, ``input_shardings``,
``pack_images``, ``bundle.spec.class_names``), so either package's callers
can drive it.

Every step runs over a mesh (``parallel/mesh.Mesh``; the one device of
``device`` when none is given): one replica of the bundle per device of the
mesh, the batch split on dim 0, each shard running the whole per-tile
program on its device, NMS kernel included, and the outputs gathered in
shard order on the mesh's first device (a one-shard step's outputs are its
shard's, with no copy).

``extra.quantize = "int8"`` runs the trunk quantized (``models/int8.py``):
with a saved calibration (``quantize_calib``) from the first call, without
one through ``SelfQuantizingStep``, which calibrates on the scan's own
first batches and swaps to int8 behind a parity gate.

``make_segment_fn`` is the segmentation model's counterpart: uint8 tiles →
preprocess → XUnet (float or int8) → sigmoid mask probabilities.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from aerial_image_recognition_tpu_torch.models.registry import (
    ModelBundle, create_model)
from aerial_image_recognition_tpu_torch.ops.nms import (
    Detections, batched_nms)
from aerial_image_recognition_tpu_torch.ops.preprocess import (
    matmul_resize_float, preprocess_batch, resize)
from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
from aerial_image_recognition_tpu_torch.post.georef import lonlat, to_numpy
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from aerial_image_recognition_tpu_torch.runtime.device import (
    canonical, on_device, resolve_device)
from aerial_image_recognition_tpu_torch.runtime.observability import Tracer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_CLAHE_BACKENDS = ("auto", "xla", "pallas", "pallas_interpret")


def _upload(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Host batch (numpy, or anything ``np.asarray`` takes) or tensor →
    ``dtype`` tensor on ``device``. Host data goes through pinned memory
    with a non-blocking copy, so the upload overlaps work already queued."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(
            x, np.uint8 if dtype == torch.uint8 else np.float32)
        if not a.flags.writeable:          # e.g. a view of a JAX array
            a = a.copy()
        x = torch.from_numpy(a)
    if x.device == device:
        return x.to(dtype)
    if device.type == "cuda" and x.device.type == "cpu":
        x = x.pin_memory()
    return x.to(device, dtype, non_blocking=True)


def _gather(outs, device: torch.device):
    """Per-shard outputs (Detections, lon, lat) → one output concatenated on
    dim 0 on ``device``, in shard order (one shard: its output as it is).
    A copy from another card waits for that card's stream (PyTorch orders
    cross-device copies)."""
    if len(outs) == 1:
        return outs[0]

    def cat(ts):
        return torch.cat([t.to(device, non_blocking=True) for t in ts])
    det = type(outs[0][0])(*(cat(f) for f in zip(*(o[0] for o in outs))))
    return det, cat([o[1] for o in outs]), cat([o[2] for o in outs])


@dataclass
class DetectStep:
    """The detection step + its host-side metadata.

    The step runs over ``mesh``: ``shard_fns`` holds each local shard's
    detect function, over its device's replica of the bundle; ``bundle`` is
    the first device's replica. ``input_shardings`` is the reference's
    surface: each local shard's (device, first row, end row) for
    ``batch`` rows when the step was built with a mesh, else None. The
    ingest ring uploads each shard's rows straight to its device
    (``mesh.rows``); the step also takes a whole host batch, or a batch on
    one device, and splits it."""
    bundle: ModelBundle
    mesh: Mesh
    shard_fns: tuple         # one (images_u8, bounds) → outputs fn a shard
    batch: int
    input_size: int          # source pixels per tile edge entering the step
    model_size: int = 640    # network input edge (pixel frame of det.boxes)
    input_shardings: Optional[tuple] = None   # ((device, lo, hi), …) or None
    # "hwc": [B,S,S,3] uint8 batches; "s2d2": [B,S/4,S/4,48], the quad
    # stem's space_to_depth² layout (ops/quadstem.host_s2d2)
    input_layout: str = "hwc"

    @property
    def device(self) -> torch.device:
        return self.bundle.device

    def __call__(self, images_u8, bounds):
        """images_u8 [B,S,S,3] uint8, bounds [B,4] (w,s,e,n) →
        (Detections, lon [B,D], lat [B,D]) as tensors on the step's
        device. Returns once the work is queued, not done. Also takes
        lists of per-shard tensors, each already on its shard's device
        (what ``place`` and the upload ring hand it)."""
        images, bounds = self.place(images_u8, bounds)
        outs = []
        for d, fn, im, bd in zip(self.mesh.devices, self.shard_fns, images,
                                 bounds):
            with on_device(d):
                outs.append(fn(im, bd))
        return _gather(outs, self.device)

    def place(self, images_u8, bounds):
        """A host or device batch → lists of each shard's rows on its
        device, in this step's layout (lists of per-shard tensors pass
        through, each packed where it lies if it is not yet). A [B,S,S,3]
        batch for the quad stem goes to each shard as it is and is relaid
        there (``pack_images`` on a tensor): the same bytes as
        ``host_s2d2`` gives, in a fraction of a millisecond on the card
        where the host's strided copy of a 64-tile batch takes tens
        (``PERF.md``)."""
        if isinstance(images_u8, (list, tuple)):
            return [self.pack_images(t) for t in images_u8], list(bounds)
        rows = self.mesh.rows(len(images_u8))
        return ([self.pack_images(_upload(images_u8[lo:hi], d, torch.uint8))
                 for d, lo, hi in rows],
                [_upload(bounds[lo:hi], d, torch.float32)
                 for d, lo, hi in rows])

    def pack_images(self, images_u8):
        """A [B,S,S,3] uint8 batch in this step's input layout: for the
        quad stem a host array goes through ``host_s2d2`` and a tensor is
        relaid where it lies (never through the host) by the same index
        map; hwc steps, and batches already packed, pass as they are."""
        if (self.input_layout == "s2d2" and hasattr(images_u8, "shape")
                and len(images_u8.shape) == 4 and images_u8.shape[-1] == 3):
            from aerial_image_recognition_tpu_torch.ops.quadstem import (
                device_s2d2, host_s2d2)
            if isinstance(images_u8, torch.Tensor):
                return device_s2d2(images_u8)
            return host_s2d2(np.asarray(images_u8))
        return images_u8


def _resolve_vote_iou(cfg: DetectorConfig):
    """extra.box_voting → the vote_iou passed to batched_nms.

    Explicitly set: that value (0/False/None = off; ``True`` is
    ``float(True)``, an IoU gate of 1.0, as in the reference). Unset: 0.5
    when multiscale is on (candidates from every scale refine the kept
    box), off single-scale (each box has ~1 voter there).
    """
    if "box_voting" in cfg.extra:
        v = cfg.extra["box_voting"]
        return float(v) if v else None
    return 0.5 if cfg.extra.get("multiscale") else None


def make_detect_fn(bundle: ModelBundle, cfg: DetectorConfig,
                   src_size: Optional[int] = None,
                   crop_size: Optional[int] = None,
                   model_size: Optional[int] = None,
                   quad: bool = False):
    """Build the (images_u8, bounds) → (Detections, lon, lat) function for
    device tensors.

    quad: the caller asserts that the images arrive in the s2d² layout
    [B,S/4,S/4,48] and go through ``bundle.forward_s2d2`` (the /255 folds
    into the quad stem); ``build_detect_step`` decides it with
    ``use_quad_stem``, other callers keep the [B,S,S,3] contract unless
    they opt in.

    src_size: source pixel edge of incoming tiles (e.g. 1024 mosaics or
    864 crops; the step resizes whatever arrives, so it only documents the
    caller's intent); crop_size: center crop before the resize; model_size
    overrides the network input edge (the model is fully convolutional;
    small sizes serve tests).

    Accuracy modes, from ``cfg.extra``: ``enhance_shadows``; ``tta`` (the
    variation ladder of ``ops/augment`` folded into the batch dimension:
    one forward for B·V images, the V candidate sets of a tile joined
    before NMS with per-variation score weights; ``tta_hist_subsample``;
    ``tta_clahe_backend`` is checked against the reference's names and
    otherwise ignored, so that a config written for it works unchanged:
    CLAHE has one path here, the CUDA kernel on the card); ``multiscale`` (a forward per scale, sizes
    rounded to multiples of 32, boxes rescaled to the base frame and
    joined before NMS; ``multiscale_weights``, default 0.8 for every
    non-native scale so that the native box wins ties against a misfit
    off-scale one; the off-native scales resize by two matrix products
    (``matmul_resize_float``), or with ``resize_matmul`` false by the
    reference's ``jax.image.resize`` lowering, ``ops/preprocess.resize``);
    ``box_voting`` (see ``_resolve_vote_iou``);
    ``nms_suppression``. ``bundle`` may be an ``Int8Bundle``: every mode
    only calls ``bundle.forward``.
    """
    spec = bundle.spec
    model_size = model_size or spec.input_size
    dtype = _DTYPES[cfg.dtype]
    extra = cfg.extra
    tta = bool(extra.get("tta", False))
    if extra.get("multiscale") \
            and extra.get("multiscale_weights") is not None \
            and len(extra["multiscale_weights"]) != len(extra["multiscale"]):
        raise ValueError(
            f"multiscale_weights has {len(extra['multiscale_weights'])} "
            f"entries for {len(extra['multiscale'])} scales")
    vote_iou = _resolve_vote_iou(cfg)
    if extra.get("tta_clahe_backend", "auto") not in _CLAHE_BACKENDS:
        raise ValueError(
            f"unknown tta_clahe_backend {extra['tta_clahe_backend']!r} "
            f"(expected one of {_CLAHE_BACKENDS})")

    def finish(boxes, scores, bounds):
        if spec.family == "rtdetr":
            det = _set_prediction_finish(boxes, scores, cfg)
            lon, lat = lonlat(det.boxes[..., :2], bounds, model_size)
            return det, lon, lat
        det = batched_nms(
            boxes, scores,
            num_classes=spec.num_classes,
            conf_threshold=cfg.confidence_threshold,
            iou_threshold=cfg.nms_iou_threshold,
            max_det=cfg.max_detections_per_tile,
            pre_topk=int(extra.get("nms_pre_topk", 256)),
            class_aware=True,
            preselect=extra.get("nms_preselect", "approx"),
            suppression=extra.get("nms_suppression"),
            vote_iou=vote_iou)
        lon, lat = lonlat(det.boxes[..., :2], bounds, model_size)
        return det, lon, lat

    def forward_tta(x):
        from aerial_image_recognition_tpu_torch.ops.augment import (
            DEFAULT_VARIATIONS, expand_tta)
        b = x.shape[0]
        xv, wts = expand_tta(
            x, clahe_hist_subsample=int(extra.get("tta_hist_subsample", 1)))
        boxes_v, scores_v = bundle.forward(xv)
        v = len(DEFAULT_VARIATIONS)
        a = boxes_v.shape[1]
        boxes = boxes_v.reshape(v, b, a, 4).transpose(0, 1) \
            .reshape(b, v * a, 4)
        scores = (scores_v.reshape(v, b, a, -1)
                  * wts[:, None, None, None].to(scores_v.dtype)) \
            .transpose(0, 1).reshape(b, v * a, -1)
        return boxes, scores

    def forward_multiscale(x):
        scales = tuple(extra["multiscale"])
        ms_wts = extra.get("multiscale_weights")
        if ms_wts is None:
            ms_wts = [1.0 if float(sc) == 1.0 else 0.8 for sc in scales]
        use_mm = bool(extra.get("resize_matmul", True))
        boxes_l, scores_l = [], []
        for sc, wt in zip(scales, ms_wts):
            size_s = max(32, int(round(model_size * sc / 32)) * 32)
            if size_s == model_size:
                xs = x
            elif use_mm:
                xs = matmul_resize_float(x, size_s, "bilinear")
            else:
                xs = resize(x, size_s, "bilinear")
            bb, ss = bundle.forward(xs)
            boxes_l.append(bb * (model_size / size_s))
            if float(wt) != 1.0:
                ss = ss * float(wt)
            scores_l.append(ss)
        return torch.cat(boxes_l, dim=1), torch.cat(scores_l, dim=1)

    @torch.inference_mode()
    def detect(images_u8: torch.Tensor, bounds: torch.Tensor):
        if quad:
            boxes, scores = bundle.forward_s2d2(images_u8)
            return finish(boxes, scores, bounds)
        x = preprocess_batch(
            images_u8, out_size=model_size, crop_size=crop_size,
            method="bilinear", dtype=dtype,
            matmul=bool(extra.get("resize_matmul", True)))
        if extra.get("enhance_shadows"):
            from aerial_image_recognition_tpu_torch.ops.augment import (
                enhance_shadows)
            x = enhance_shadows(x)
        if tta:
            boxes, scores = forward_tta(x)
        elif extra.get("multiscale"):
            boxes, scores = forward_multiscale(x)
        else:
            boxes, scores = bundle.forward(x)
        return finish(boxes, scores, bounds)

    return detect


def _set_prediction_finish(boxes, scores, cfg: DetectorConfig) -> Detections:
    """A set-prediction detector's answer (RT-DETR's published
    post-process with its focal-loss scores), with no NMS: boxes [B,Q,4],
    sigmoid scores [B,Q,nc] → the top ``max_detections_per_tile`` over
    query × class (one query may give a detection of each class), kept
    where the score exceeds ``confidence_threshold``, in the padded
    ``Detections`` of the NMS path (invalid slots zero, class −1)."""
    with Tracer.annotate("rtdetr.finish"):
        b, q, nc = scores.shape
        slots = cfg.max_detections_per_tile
        k = min(slots, q * nc)
        top, idx = torch.topk(scores.reshape(b, q * nc).float(), k, dim=1)
        picked = torch.gather(boxes.float(), 1,
                              (idx // nc)[..., None].expand(b, k, 4))
        cls = (idx % nc).to(torch.int32)
        if k < slots:
            pad = slots - k
            top = torch.cat([top, top.new_zeros(b, pad)], 1)
            picked = torch.cat([picked, picked.new_zeros(b, pad, 4)], 1)
            cls = torch.cat([cls, cls.new_full((b, pad), -1)], 1)
        valid = top > cfg.confidence_threshold
        return Detections(boxes=torch.where(valid[..., None], picked, 0.0),
                          scores=torch.where(valid, top, 0.0),
                          classes=torch.where(valid, cls, -1), valid=valid)


def use_quad_stem(bundle, cfg: DetectorConfig, *, src_size=None,
                  crop_size=None, model_size=None) -> bool:
    """True when the quad-stem lowering applies: a model with two stride-2
    3×3 stems (yolov7-tiny, yolov8 n–x), native-size tiles (no crop or
    resize on the device, the model size a multiple of 4), and none of the
    pixel-space options that need the [B,S,S,3] image (TTA, multiscale,
    shadow enhancement). ``extra.quad_stem: false`` opts out."""
    if not bool(cfg.extra.get("quad_stem", True)):
        return False
    if not bundle.supports_s2d2():
        return False
    eff_model = model_size or bundle.spec.input_size
    if eff_model % 4:
        return False
    # the quad stem reads the raw tile pixels: a crop or resize on the
    # device would have to come before it, so those keep the plain stems
    if crop_size is not None or src_size not in (None, eff_model):
        return False
    for key in ("tta", "multiscale", "enhance_shadows"):
        if cfg.extra.get(key):
            return False
    return True


def build_detect_step(cfg: Optional[DetectorConfig] = None, *,
                      batch: Optional[int] = None,
                      bundle: Optional[ModelBundle] = None,
                      src_size: Optional[int] = None,
                      crop_size: Optional[int] = None,
                      model_size: Optional[int] = None,
                      mesh=None,
                      device: Optional[Union[str, torch.device]] = None):
    """Build the detect step on ``device`` (default ``cuda``; raises without
    CUDA unless a device is given).

    The model is the BN-folded deploy form of ``cfg.model_path`` with the
    weights of ``cfg.params_path`` (random from seed 0 without one), its
    trunk in ``cfg.dtype`` and its heads in f32. Tiles of ``src_size`` px
    (center-cropped to ``crop_size`` first, if given) are resized to the
    model size on the device. The accuracy modes of ``make_detect_fn`` come
    from ``cfg.extra``.

    ``extra.quantize == "int8"`` quantizes the trunk (``models/int8.py``):
    with ``extra.quantize_calib`` (a file written by ``save_absmax``) up
    front, returning a ``DetectStep`` over an ``Int8Bundle``; without one it
    returns a ``SelfQuantizingStep``, which self-calibrates on the scan's
    own first batches behind a parity gate with automatic fallback to the
    float step. A pre-built ``Int8Bundle`` may be passed as ``bundle``.

    ``mesh`` (``parallel/mesh.Mesh``): the data-parallel step over the
    mesh's local devices (``device`` defaults to the mesh's first); the
    batch must divide evenly over them (ValueError naming the mesh).
    Without one the step runs over a mesh of its one device. Turnkey int8
    keeps the mesh through its rebuild.

    Native-size tiles of a model with the quad-stem lowering take it
    (``use_quad_stem``): the step's ``input_layout`` is then "s2d2", its
    ``pack_images`` relays [B,S,S,3] batches, and each shard's rows of an
    s2d² batch go to its device as they are.
    """
    if mesh is not None and device is None:
        device = mesh.devices[0]
    device = resolve_device(device)
    cfg = cfg or DetectorConfig()
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    if bundle is None:
        bundle = create_model(cfg.model_path, dtype=_DTYPES[cfg.dtype],
                              params_path=cfg.params_path, device=device,
                              fold_bn=True)
    elif bundle.device != device:
        raise ValueError(f"bundle lives on {bundle.device}, step asked for "
                         f"{device}")
    kwargs = dict(batch=batch, src_size=src_size, crop_size=crop_size,
                  model_size=model_size, mesh=mesh)
    if cfg.extra.get("quantize") == "int8" \
            and bundle.spec.family == "rtdetr":
        raise NotImplementedError(
            "quantize='int8' has no lowering for the rtdetr family: its "
            "trunk runs in the configured dtype")
    if cfg.extra.get("quantize") == "int8":
        from aerial_image_recognition_tpu_torch.models.int8 import (
            Int8Bundle, load_absmax, quantize_bundle)
        calib = cfg.extra.get("quantize_calib")
        if isinstance(bundle, Int8Bundle):
            pass                                 # quantized by the caller
        elif calib:
            bundle = quantize_bundle(bundle, [], absmax=load_absmax(calib))
        else:
            return SelfQuantizingStep(
                _compile_detect_step(bundle, cfg, **kwargs), cfg, kwargs)
    return _compile_detect_step(bundle, cfg, **kwargs)


def _compile_detect_step(bundle, cfg: DetectorConfig, *,
                         batch: Optional[int] = None,
                         src_size: Optional[int] = None,
                         crop_size: Optional[int] = None,
                         model_size: Optional[int] = None,
                         mesh: Optional[Mesh] = None) -> DetectStep:
    """A DetectStep for an already-resolved bundle (the shared tail of
    ``build_detect_step`` and the int8 self-calibration rebuild). Nothing
    is compiled: PyTorch runs eagerly. The bundle is replicated to each
    distinct device of the mesh other than its own (``bundle.to``; shards
    on one device share its replica)."""
    quad = use_quad_stem(bundle, cfg, src_size=src_size, crop_size=crop_size,
                         model_size=model_size)
    model_size = model_size or bundle.spec.input_size
    eff_batch = batch or cfg.device_batch
    given = mesh is not None
    mesh = mesh or Mesh([bundle.device])
    if eff_batch % mesh.local_size:
        raise ValueError(
            f"device_batch {eff_batch} must divide evenly over the "
            f"{mesh.local_size}-device '{mesh.axis_name}' mesh axis (set "
            f"device_batch to a multiple of {mesh.local_size})")
    fns = {}
    for d in mesh.distinct_devices:
        replica = bundle if canonical(bundle.device) == canonical(d) \
            else bundle.to(d)
        fns[d] = (replica, make_detect_fn(replica, cfg, src_size=src_size,
                                          crop_size=crop_size,
                                          model_size=model_size, quad=quad))
    return DetectStep(bundle=fns[mesh.devices[0]][0], mesh=mesh,
                      shard_fns=tuple(fns[d][1] for d in mesh.devices),
                      batch=eff_batch, input_size=src_size or model_size,
                      model_size=model_size,
                      input_shardings=mesh.rows(eff_batch) if given else None,
                      input_layout="s2d2" if quad else "hwc")


def detection_sets_agree(out_a, out_b, *, min_match_frac: float = 0.9,
                         iou_threshold: float = 0.5,
                         max_mean_score_delta: float = 0.05):
    """Compare two detect-step outputs (Detections, lon, lat) for practical
    equivalence: per image, greedy same-class IoU≥0.5 matching; pass iff
    matched ≥ min_match_frac of the larger set AND the mean |Δscore| over
    matches stays small. Returns (ok, stats_dict)."""
    det_a, det_b = out_a[0], out_b[0]
    va, vb = to_numpy(det_a.valid), to_numpy(det_b.valid)
    ba, bb = to_numpy(det_a.boxes), to_numpy(det_b.boxes)
    sa, sb = to_numpy(det_a.scores), to_numpy(det_b.scores)
    ca, cb = to_numpy(det_a.classes), to_numpy(det_b.classes)
    total_a = int(va.sum())
    total_b = int(vb.sum())
    matched = 0
    deltas = []
    for i in range(va.shape[0]):
        ia, ib = np.where(va[i])[0], np.where(vb[i])[0]
        if not len(ia) or not len(ib):
            continue
        A, B = ba[i][ia], bb[i][ib]
        ax1, ay1 = A[:, 0] - A[:, 2] / 2, A[:, 1] - A[:, 3] / 2
        ax2, ay2 = A[:, 0] + A[:, 2] / 2, A[:, 1] + A[:, 3] / 2
        bx1, by1 = B[:, 0] - B[:, 2] / 2, B[:, 1] - B[:, 3] / 2
        bx2, by2 = B[:, 0] + B[:, 2] / 2, B[:, 1] + B[:, 3] / 2
        ix = np.maximum(0.0, np.minimum(ax2[:, None], bx2[None, :])
                        - np.maximum(ax1[:, None], bx1[None, :]))
        iy = np.maximum(0.0, np.minimum(ay2[:, None], by2[None, :])
                        - np.maximum(ay1[:, None], by1[None, :]))
        inter = ix * iy
        union = ((ax2 - ax1) * (ay2 - ay1))[:, None] \
            + ((bx2 - bx1) * (by2 - by1))[None, :] - inter
        iou = inter / np.maximum(union, 1e-9)
        iou[ca[i][ia][:, None] != cb[i][ib][None, :]] = 0.0
        used = np.zeros(len(ib), bool)
        for j in np.argsort(-sa[i][ia], kind="stable"):
            k = int(np.argmax(np.where(used, -1.0, iou[j])))
            if iou[j, k] >= iou_threshold and not used[k]:
                used[k] = True
                matched += 1
                deltas.append(abs(float(sa[i][ia[j]]) -
                                  float(sb[i][ib[k]])))
    bigger = max(total_a, total_b)
    mean_delta = float(np.mean(deltas)) if deltas else 0.0
    ok = (matched >= min_match_frac * bigger if bigger else True) \
        and mean_delta <= max_mean_score_delta
    return ok, {"total_a": total_a, "total_b": total_b,
                "matched": matched, "mean_score_delta": round(mean_delta, 4)}


class SelfQuantizingStep:
    """Turnkey int8: a DetectStep shim that calibrates itself on the scan's
    own first batches, then hot-swaps to the int8-quantized step behind a
    NON-VACUOUS parity gate. ``extra.quantize = "int8"`` with no
    calibration file is all a caller sets.

    Semantics:

    * The first ``quantize_calib_batches`` (default 2) batches run in the
      float step (their results are final — nothing is reprocessed) and
      their images calibrate the activation absmax table.
    * The swap additionally requires a *detection-bearing* reference
      batch: calibration keeps waiting (float step, no further image
      collection) until some batch's output holds at least
      ``quantize_parity_min_detections`` (default 1) detections; that
      batch's images join the calibration set and its output anchors the
      parity gate (``detection_sets_agree``), so the gate can never pass on
      an empty-vs-empty comparison.
    * Bounded wait, settling on the float step: after
      ``quantize_calib_wait_batches`` (default 16) batches with no
      detection anywhere, the step STAYS float (state 'bf16-fallback',
      reason recorded) — correctness-neutral by definition on the
      detections seen so far, and it ends the per-batch host readback the
      wait costs. Swapping unvalidated would be unsound: an int8 trunk
      calibrated on degenerate content can silently DROP detections, and a
      gate keyed on the int8 output's own detections can never see them.
      Scans known to start sparse (ocean approach, cloud deck) should raise
      ``quantize_calib_wait_batches``.
    * A checkpoint that cannot be quantized (``quantize_bundle`` raises
      ``KeyError``/``ValueError``, or ``NotImplementedError`` for a model
      int8 does not cover, as ``YOLOv7(s2d_stem=True)``) or a parity miss ⇒
      the scan continues in the float step (state 'bf16-fallback', reason
      recorded and printed), as the reference's does.
      Nothing else is caught: an error of the int8 step itself (a kernel
      that does not build or launch, a refused integer product) propagates
      to the caller.

    States: 'calibrating' → 'int8' | 'bf16-fallback' (the name holds for an
    f32 base step too); observable via ``.quantize_state``/``.parity``/
    ``.fallback_reason``.

    A collected batch is copied to the host once, from whatever arrived
    (numpy, a device tensor or a data-parallel step's per-shard tensors),
    before the step runs, and a quad-stem step's s2d² batch is relaid to
    [B,S,S,3] there (``host_s2d2_inverse``) for the calibration forward;
    other batches cost no copy. The int8 rebuild must take the float
    step's layout (a RuntimeError otherwise). The reference batch
    is kept as a device copy of the tensors the float step ran on (the
    caller may reuse its buffers, as ``run_pipeline``'s upload ring does)
    and replayed through the int8 step from there. Under a mesh the
    calibration reads the whole (sharded) batch, and the int8 rebuild keeps
    the mesh: every shard then runs the epilogue kernel.
    """

    def __init__(self, base: DetectStep, cfg: DetectorConfig, kwargs: dict):
        self._base = base
        self._active = base
        self._cfg = cfg
        self._kwargs = kwargs
        self._target = max(1, int(cfg.extra.get("quantize_calib_batches",
                                                2)))
        self._min_det = max(1, int(cfg.extra.get(
            "quantize_parity_min_detections", 1)))
        self._max_wait = max(self._target, int(cfg.extra.get(
            "quantize_calib_wait_batches", 16)))
        self._collected = []      # host uint8 [B,S,S,3] copies
        self._ref = None          # (device images, device bounds, out)
        self._seen = 0            # batches observed while calibrating
        self.quantize_state = "calibrating"
        self.parity = None
        self.fallback_reason = None

    @property
    def active_step(self) -> DetectStep:
        """The DetectStep currently serving calls (float until the swap)."""
        return self._active

    @property
    def base_step(self) -> DetectStep:
        """The float step (kept after the swap, for A/Bs against it)."""
        return self._base

    # -- DetectStep surface (CarDetector/run_pipeline/serve read these) --
    @property
    def bundle(self):
        return self._active.bundle

    @property
    def device(self) -> torch.device:
        return self._active.device

    @property
    def batch(self):
        return self._active.batch

    @property
    def input_size(self):
        return self._active.input_size

    @property
    def model_size(self):
        return self._active.model_size

    @property
    def mesh(self):
        return self._active.mesh

    @property
    def input_shardings(self):
        return self._active.input_shardings

    @property
    def input_layout(self):
        return self._active.input_layout

    def pack_images(self, images_u8):
        return self._active.pack_images(images_u8)

    def place(self, images_u8, bounds):
        return self._active.place(images_u8, bounds)

    @staticmethod
    def _host_copy(images) -> np.ndarray:
        if isinstance(images, (list, tuple)):       # per-shard tensors
            return np.concatenate([SelfQuantizingStep._host_copy(t)
                                   for t in images])
        if isinstance(images, torch.Tensor):
            return images.detach().to("cpu", torch.uint8).numpy().copy()
        return np.array(images, dtype=np.uint8)

    def __call__(self, images, bounds):
        if self.quantize_state != "calibrating":
            return self._active(images, bounds)
        collect = len(self._collected) < self._target
        host = self._host_copy(images) if collect else None
        dev_images, dev_bounds = self._base.place(images, bounds)
        out = self._base(dev_images, dev_bounds)
        self._seen += 1
        # non-vacuous gate: a parity reference must carry detections
        ndet = int(out[0].valid.sum())
        if ndet >= self._min_det and self._ref is None:
            # copies: a caller may reuse its device buffers for later
            # batches (run_pipeline's upload ring does) before the replay
            self._ref = ([t.clone() for t in dev_images],
                         [t.clone() for t in dev_bounds], out)
            if not collect:
                # the reference batch joins the calibration set so absmax
                # sees detection-bearing content even when the first
                # `target` batches were empty scenery
                collect, host = True, self._host_copy(images)
        if collect:
            if self._base.input_layout == "s2d2" and host.shape[-1] != 3:
                from aerial_image_recognition_tpu_torch.ops.quadstem import (
                    host_s2d2_inverse)
                host = host_s2d2_inverse(host)
            self._collected.append(host)
        if len(self._collected) >= self._target and self._ref is not None:
            self._quantize()
        elif self._seen >= self._max_wait:
            # settle on the float step: no detection-bearing batch to
            # validate against within the wait budget
            self.quantize_state = "bf16-fallback"
            self.fallback_reason = (
                f"no detections in the first {self._seen} batches to "
                "validate int8 parity — staying bf16 (raise "
                "quantize_calib_wait_batches for scans that start sparse)")
            print(f"int8 self-calibration: {self.fallback_reason}")
            self._collected = []
            self._ref = None
        return out

    def _quantize(self):
        from aerial_image_recognition_tpu_torch.models.int8 import (
            quantize_bundle)
        images, bounds, base_out = self._ref
        # 8-row calibration chunks: absmax is a running max, so chunking
        # is exact, and a chunk's activations stay small
        calib = [c[i:i + 8] for c in self._collected
                 for i in range(0, len(c), 8)]
        self._collected = []
        self._ref = None
        try:
            qb = quantize_bundle(self._base.bundle, calib,
                                 model_size=self._base.model_size)
        except (KeyError, ValueError, NotImplementedError) as e:
            # the checkpoint cannot be quantized (a calibration record or
            # the f32 variables are missing, the transcription does not fit,
            # or int8 does not cover the model: the s2d_stem experiment)
            self._fall_back(repr(e))
            return
        # outside the try: a kernel that does not build or launch, or an
        # integer product the card refuses, is a fault and propagates
        qstep = _compile_detect_step(qb, self._cfg, **self._kwargs)
        if qstep.input_layout != self._base.input_layout:
            raise RuntimeError(
                f"int8 step layout {qstep.input_layout!r} != float "
                f"{self._base.input_layout!r}: ingest batches would be "
                "misshaped")
        qout = qstep(images, bounds)
        ok, stats = detection_sets_agree(base_out, qout)
        self.parity = stats
        if not ok:
            self._fall_back(
                f"first-batch bf16-vs-int8 parity check failed: {stats}")
            return
        self._active = qstep
        self.quantize_state = "int8"
        print(f"int8 self-calibration: switched to int8 after "
              f"{self._seen} batches (parity {stats})")

    def _fall_back(self, reason: str):
        self.quantize_state = "bf16-fallback"
        self.fallback_reason = reason
        print(f"int8 self-calibration failed — continuing in bf16: {reason}")


def make_segment_fn(bundle, cfg: DetectorConfig):
    """XUnet path: uint8 tiles [B,H,W,3] (numpy or a tensor) → sigmoid
    mask probabilities [B,S,S,1] f32 on the bundle's device, S the model's
    input size. Tiles of another size are resized there by the matrix
    product (``preprocess_batch``). ``bundle`` is the xunet
    ``ModelBundle`` or its ``Int8XUnetBundle``.

    The function carries its weights (the reference's takes a params tree
    beside the images); it returns once the work is queued on the card."""
    model_size = bundle.spec.input_size
    dtype = _DTYPES[cfg.dtype]

    @torch.inference_mode()
    def segment(images_u8):
        x = preprocess_batch(_upload(images_u8, bundle.device, torch.uint8),
                             out_size=model_size, dtype=dtype)
        return torch.sigmoid(bundle.forward(x))

    return segment
