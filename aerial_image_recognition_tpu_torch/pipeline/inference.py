"""The fused detection step: uint8 tiles → georeferenced detections.

Counterpart of ``aerial_image_recognition_tpu/pipeline/inference.py``
(``DetectStep``, ``make_detect_fn``, ``build_detect_step``,
``detection_sets_agree``). One call runs preprocess (crop, resize, /255) →
trunk (any registry detector) → f32 heads → decode → NMS (CUDA kernel on
the card; class-aware for the two-class yolov8 models) →
lon/lat on the device, so only ~max_det·6 numbers per tile come back to the
host. The accuracy modes — the TTA ladder (whose CLAHE variations run the
CUDA LUT-apply kernel on the card), multiscale, box voting, shadow
enhancement — widen the middle of that chain and leave its ends as they
are.

PyTorch runs eagerly, so there is no compile step: the step is a plain
function over device tensors. ``DetectStep`` keeps the surface that
``CarDetector``, ``run_pipeline`` and the server read (``batch``,
``input_size``, ``model_size``, ``input_layout``, ``input_shardings``,
``pack_images``, ``bundle.spec.class_names``), so either package's callers
can drive it.

``extra.quantize = "int8"`` runs the trunk quantized (``models/int8.py``):
with a saved calibration (``quantize_calib``) from the first call, without
one through ``SelfQuantizingStep``, which calibrates on the scan's own
first batches and swaps to int8 behind a parity gate.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from aerial_image_recognition_tpu_torch.models.registry import (
    ModelBundle, create_model)
from aerial_image_recognition_tpu_torch.ops.nms import batched_nms
from aerial_image_recognition_tpu_torch.ops.preprocess import (
    matmul_resize_float, preprocess_batch)
from aerial_image_recognition_tpu_torch.post.georef import lonlat, to_numpy
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from aerial_image_recognition_tpu_torch.runtime.device import resolve_device

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


@dataclass
class DetectStep:
    """The detection step + its host-side metadata."""
    bundle: ModelBundle
    fn: Callable  # (images_u8 [B,S,S,3], bounds [B,4] f32) on device
    batch: int
    input_size: int          # source pixels per tile edge entering the step
    model_size: int = 640    # network input edge (pixel frame of det.boxes)
    input_shardings: Optional[tuple] = None   # single device: always None
    input_layout: str = "hwc"                 # [B,S,S,3] uint8 batches

    @property
    def device(self) -> torch.device:
        return self.bundle.device

    def __call__(self, images_u8, bounds):
        """images_u8 [B,S,S,3] uint8, bounds [B,4] (w,s,e,n) →
        (Detections, lon [B,D], lat [B,D]) as tensors on the step's
        device. Returns once the work is queued, not done."""
        images = _upload(self.pack_images(images_u8), self.device,
                         torch.uint8)
        return self.fn(images, _upload(bounds, self.device, torch.float32))

    def pack_images(self, images_u8):
        """This step takes [B,S,S,3] batches as they are."""
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
                   model_size: Optional[int] = None):
    """Build the (images_u8, bounds) → (Detections, lon, lat) function for
    device tensors.

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
    off-scale one; with ``resize_matmul`` false it raises
    NotImplementedError, as the non-matrix resize is not ported);
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
    if extra.get("multiscale") and not extra.get("resize_matmul", True):
        # the reference resizes the off-native scales with jax.image.resize
        # there; the port has only the matrix-product resize
        raise NotImplementedError(
            "multiscale with resize_matmul=False is not ported: the port "
            "resizes by matrix products, bilinear or lanczos3")
    if extra.get("tta_clahe_backend", "auto") not in _CLAHE_BACKENDS:
        raise ValueError(
            f"unknown tta_clahe_backend {extra['tta_clahe_backend']!r} "
            f"(expected one of {_CLAHE_BACKENDS})")

    def finish(boxes, scores, bounds):
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
        boxes_l, scores_l = [], []
        for sc, wt in zip(scales, ms_wts):
            size_s = max(32, int(round(model_size * sc / 32)) * 32)
            xs = x if size_s == model_size \
                else matmul_resize_float(x, size_s, "bilinear")
            bb, ss = bundle.forward(xs)
            boxes_l.append(bb * (model_size / size_s))
            if float(wt) != 1.0:
                ss = ss * float(wt)
            scores_l.append(ss)
        return torch.cat(boxes_l, dim=1), torch.cat(scores_l, dim=1)

    @torch.inference_mode()
    def detect(images_u8: torch.Tensor, bounds: torch.Tensor):
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
    ``mesh`` data parallelism raises NotImplementedError naming its slice.
    """
    device = resolve_device(device)
    cfg = cfg or DetectorConfig()
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel steps arrive with the multi-GPU slice")
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
                  model_size=model_size)
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
                         model_size: Optional[int] = None) -> DetectStep:
    """A DetectStep for an already-resolved bundle (the shared tail of
    ``build_detect_step`` and the int8 self-calibration rebuild). Nothing
    is compiled: PyTorch runs eagerly."""
    model_size = model_size or bundle.spec.input_size
    return DetectStep(bundle=bundle,
                      fn=make_detect_fn(bundle, cfg, src_size=src_size,
                                        crop_size=crop_size,
                                        model_size=model_size),
                      batch=batch or cfg.device_batch,
                      input_size=src_size or model_size,
                      model_size=model_size)


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
      ``KeyError``/``ValueError``) or a parity miss ⇒ the scan continues in
      the float step (state 'bf16-fallback', reason recorded and printed).
      Nothing else is caught: an error of the int8 step itself (a kernel
      that does not build or launch, a refused integer product) propagates
      to the caller.

    States: 'calibrating' → 'int8' | 'bf16-fallback' (the name holds for an
    f32 base step too); observable via ``.quantize_state``/``.parity``/
    ``.fallback_reason``.

    A collected batch is copied to the host once, from whatever arrived
    (numpy or a device tensor), before the step runs; other batches cost no
    copy. The reference batch is kept as a device copy of the tensors the
    float step ran on (the caller may reuse its buffers, as
    ``run_pipeline``'s upload ring does) and replayed through the int8 step
    from there.
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
    def input_shardings(self):
        return self._active.input_shardings

    @property
    def input_layout(self):
        return self._active.input_layout

    def pack_images(self, images_u8):
        return self._active.pack_images(images_u8)

    @staticmethod
    def _host_copy(images) -> np.ndarray:
        if isinstance(images, torch.Tensor):
            return images.detach().to("cpu", torch.uint8).numpy().copy()
        return np.array(images, dtype=np.uint8)

    def __call__(self, images, bounds):
        if self.quantize_state != "calibrating":
            return self._active(images, bounds)
        collect = len(self._collected) < self._target
        host = self._host_copy(images) if collect else None
        dev_images = _upload(self._base.pack_images(images), self.device,
                             torch.uint8)
        dev_bounds = _upload(bounds, self.device, torch.float32)
        out = self._base(dev_images, dev_bounds)
        self._seen += 1
        # non-vacuous gate: a parity reference must carry detections
        ndet = int(out[0].valid.sum())
        if ndet >= self._min_det and self._ref is None:
            # copies: a caller may reuse its device buffers for later
            # batches (run_pipeline's upload ring does) before the replay
            self._ref = (dev_images.clone(), dev_bounds.clone(), out)
            if not collect:
                # the reference batch joins the calibration set so absmax
                # sees detection-bearing content even when the first
                # `target` batches were empty scenery
                collect, host = True, self._host_copy(images)
        if collect:
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
        except (KeyError, ValueError) as e:
            # the checkpoint cannot be quantized (a calibration record or
            # the f32 variables are missing, the transcription does not fit)
            self._fall_back(repr(e))
            return
        # outside the try: a kernel that does not build or launch, or an
        # integer product the card refuses, is a fault and propagates
        qstep = _compile_detect_step(qb, self._cfg, **self._kwargs)
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
