"""The fused detection step: uint8 tiles → georeferenced detections.

Counterpart of ``aerial_image_recognition_tpu/pipeline/inference.py``
(``DetectStep``, ``make_detect_fn``, ``build_detect_step``,
``detection_sets_agree``). One call runs preprocess → YOLOv7-tiny trunk →
f32 heads → decode → NMS (CUDA kernel on the card) → lon/lat on the device,
so only ~max_det·6 numbers per tile come back to the host.

PyTorch runs eagerly, so there is no compile step: the step is a plain
function over device tensors. ``DetectStep`` keeps the surface that
``CarDetector``, ``run_pipeline`` and the server read (``batch``,
``input_size``, ``model_size``, ``input_layout``, ``input_shardings``,
``pack_images``, ``bundle.spec.class_names``), so either package's callers
can drive it.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from aerial_image_recognition_tpu_torch.models.registry import (
    ModelBundle, create_model)
from aerial_image_recognition_tpu_torch.ops.nms import batched_nms
from aerial_image_recognition_tpu_torch.ops.preprocess import preprocess_batch
from aerial_image_recognition_tpu_torch.post.georef import lonlat, to_numpy
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from aerial_image_recognition_tpu_torch.runtime.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# config switches of the reference whose code arrives with a later slice
_LATER_EXTRAS = {
    "tta": "accuracy-modes",
    "multiscale": "accuracy-modes",
    "box_voting": "accuracy-modes",
    "enhance_shadows": "accuracy-modes",
}


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


def make_detect_fn(bundle: ModelBundle, cfg: DetectorConfig,
                   model_size: Optional[int] = None):
    """Build the (images_u8, bounds) → (Detections, lon, lat) function for
    device tensors. model_size overrides the network input edge (the model
    is fully convolutional; small sizes serve tests)."""
    spec = bundle.spec
    model_size = model_size or spec.input_size
    dtype = _DTYPES[cfg.dtype]

    @torch.inference_mode()
    def detect(images_u8: torch.Tensor, bounds: torch.Tensor):
        x = preprocess_batch(images_u8, out_size=model_size, dtype=dtype)
        boxes, scores = bundle.forward(x)
        det = batched_nms(
            boxes, scores,
            num_classes=spec.num_classes,
            conf_threshold=cfg.confidence_threshold,
            iou_threshold=cfg.nms_iou_threshold,
            max_det=cfg.max_detections_per_tile,
            pre_topk=int(cfg.extra.get("nms_pre_topk", 256)),
            class_aware=True,
            preselect=cfg.extra.get("nms_preselect", "approx"))
        lon, lat = lonlat(det.boxes[..., :2], bounds, model_size)
        return det, lon, lat

    return detect


def build_detect_step(cfg: Optional[DetectorConfig] = None, *,
                      batch: Optional[int] = None,
                      bundle: Optional[ModelBundle] = None,
                      src_size: Optional[int] = None,
                      model_size: Optional[int] = None,
                      mesh=None,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> DetectStep:
    """Build the detect step on ``device`` (default ``cuda``; raises without
    CUDA unless a device is given).

    The model is the BN-folded deploy form of ``cfg.model_path`` with the
    weights of ``cfg.params_path`` (random from seed 0 without one), its
    trunk in ``cfg.dtype`` and its heads in f32. Tiles must arrive at the
    model size: a ``src_size`` that needs resizing, ``mesh`` data
    parallelism, turnkey int8 and the accuracy modes raise
    NotImplementedError naming the slice that brings them.
    """
    device = resolve_device(device)
    cfg = cfg or DetectorConfig()
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel steps arrive with the multi-GPU slice")
    if cfg.extra.get("quantize") == "int8":
        raise NotImplementedError("int8 steps arrive with the turnkey-int8 "
                                  "slice")
    for key, slice_name in _LATER_EXTRAS.items():
        if cfg.extra.get(key):
            raise NotImplementedError(
                f"extra.{key} arrives with the {slice_name} slice")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    if bundle is None:
        bundle = create_model(cfg.model_path, dtype=_DTYPES[cfg.dtype],
                              params_path=cfg.params_path, device=device,
                              fold_bn=True)
    elif bundle.device != device:
        raise ValueError(f"bundle lives on {bundle.device}, step asked for "
                         f"{device}")
    model_size = model_size or bundle.spec.input_size
    if src_size not in (None, model_size):
        raise NotImplementedError(
            f"{src_size}-px tiles need the device resize to {model_size} "
            "px, which arrives with the preprocess slice")
    return DetectStep(bundle=bundle,
                      fn=make_detect_fn(bundle, cfg, model_size=model_size),
                      batch=batch or cfg.device_batch,
                      input_size=model_size, model_size=model_size)


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
