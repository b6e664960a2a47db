"""Single-image prediction — the notebook's visual spot-check workflow.

Counterpart of ``aerial_image_recognition_tpu/pipeline/predict.py``. The
reference spot-checks its trained models by running them on
`test_tile.jpg` / `img/test_images/*.jpg` and drawing the boxes
(x_arch/01_train_tokyo.ipynb cells 27-29); the deployment path resizes
whatever it gets to the model size (`_script/gpu_handler.py:74-76`).
This module is that workflow as a library call + CLI verb: arbitrary-size
images are resized on the host (PIL bilinear), each chunk is uploaded once
and runs preprocess → model → batched NMS on the card (bf16 trunk, the
CUDA suppression kernel), and the boxes are scaled back to the ORIGINAL
pixel grid on the host; an annotated copy can be written for the eyeball
check the notebook did inline.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class ImagePrediction:
    path: str
    width: int
    height: int
    boxes_xyxy: np.ndarray      # [N,4] float, original-image pixels
    classes: np.ndarray         # [N] int
    scores: np.ndarray          # [N] float
    class_names: Sequence[str]

    def to_json(self) -> Dict:
        names = list(self.class_names)
        return {
            "path": self.path, "width": self.width, "height": self.height,
            "detections": [
                {"box_xyxy": [round(float(v), 2) for v in b],
                 "class": int(c),
                 "label": names[int(c)] if int(c) < len(names) else str(int(c)),
                 "score": round(float(s), 4)}
                for b, c, s in zip(self.boxes_xyxy, self.classes,
                                   self.scores)],
        }


def _load_rgb(path: str) -> np.ndarray:
    from aerial_image_recognition_tpu_torch.gio.decode import decode_rgb
    with open(path, "rb") as f:
        arr = decode_rgb(f.read())
    if arr is None:
        raise ValueError(f"undecodable image {path!r}")
    return arr


def predict_images(paths: Sequence[str], *, model: str = "yolov7_itcvd",
                   params: Optional[str] = None,
                   confidence: float = 0.25,
                   iou_threshold: float = 0.45,
                   max_det: int = 128,
                   batch: int = 16,
                   imgsz: Optional[int] = None,
                   device=None) -> List[ImagePrediction]:
    """Run detection on image files of ANY size (reference behavior:
    resize to the model input — gpu_handler.py:74-76) and return boxes in
    each image's own pixel coordinates.

    imgsz: inference resolution (default: the registry input size). The
    networks are fully convolutional, so a checkpoint trained at another
    tile geometry — e.g. the 96 px fake-world fixtures — can be run at
    its own scale. The model runs on ``device`` (default ``cuda``; raises
    without CUDA). Every chunk is padded to ``batch`` images, so the last,
    shorter chunk runs the same shapes as the others and its images get
    the results they would get in a full chunk."""
    import torch
    from PIL import Image

    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.ops.nms import batched_nms
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    from aerial_image_recognition_tpu_torch.pipeline.inference import _upload
    from aerial_image_recognition_tpu_torch.post.georef import to_numpy

    bundle = create_model(model, dtype=torch.bfloat16, params_path=params,
                          device=device, fold_bn=True)
    s = imgsz or bundle.spec.input_size
    nc = bundle.spec.num_classes

    @torch.inference_mode()
    def infer(images_u8):
        x = preprocess_batch(images_u8, out_size=s, dtype=torch.bfloat16)
        boxes, scores = bundle.forward(x)
        return batched_nms(boxes, scores, num_classes=nc,
                           conf_threshold=confidence,
                           iou_threshold=iou_threshold, max_det=max_det)

    out: List[ImagePrediction] = []
    for i0 in range(0, len(paths), batch):
        # decode per chunk — a directory of ~1800-px city crops decoded
        # up front would hold every ~10 MB array simultaneously
        chunk = [(p, _load_rgb(p)) for p in paths[i0:i0 + batch]]
        resized = np.zeros((batch, s, s, 3), np.uint8)
        for k, (_p, arr) in enumerate(chunk):
            if arr.shape[0] != s or arr.shape[1] != s:
                arr = np.asarray(Image.fromarray(arr).resize(
                    (s, s), Image.BILINEAR), dtype=np.uint8)
            resized[k] = arr
        det = infer(_upload(resized, bundle.device, torch.uint8))
        valid, boxes, classes, scores = (to_numpy(t) for t in (
            det.valid, det.boxes, det.classes, det.scores))
        for bi, (p, arr) in enumerate(chunk):
            v = valid[bi].astype(bool)
            b = boxes[bi].astype(np.float32)[v]          # cxcywh, model px
            cls = classes[bi][v].astype(int)
            sc = scores[bi].astype(np.float32)[v]
            h, w = arr.shape[:2]
            fx, fy = w / s, h / s
            x1 = (b[:, 0] - b[:, 2] / 2) * fx
            y1 = (b[:, 1] - b[:, 3] / 2) * fy
            x2 = (b[:, 0] + b[:, 2] / 2) * fx
            y2 = (b[:, 1] + b[:, 3] / 2) * fy
            xyxy = np.stack([np.clip(x1, 0, w), np.clip(y1, 0, h),
                             np.clip(x2, 0, w), np.clip(y2, 0, h)], axis=1)
            out.append(ImagePrediction(
                path=p, width=w, height=h, boxes_xyxy=xyxy,
                classes=cls, scores=sc,
                class_names=bundle.spec.class_names))
    return out


def draw_predictions(pred: ImagePrediction, out_path: str,
                     color=(255, 40, 40), width: int = 2) -> None:
    """Write an annotated copy (the notebook's inline box drawing)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(_load_rgb(pred.path))
    dr = ImageDraw.Draw(img)
    for b, s in zip(pred.boxes_xyxy, pred.scores):
        dr.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                     outline=color, width=width)
        dr.text((float(b[0]), max(0.0, float(b[1]) - 12)), f"{s:.2f}",
                fill=color)
    img.save(out_path)
