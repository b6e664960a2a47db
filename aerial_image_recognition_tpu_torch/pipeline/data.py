"""Training data pipeline: COCO labels → padded YOLO target tensors.

Copy of ``aerial_image_recognition_tpu/pipeline/data.py`` (numpy and PIL
only): COCO-JSON → YOLO label conversion with the Tokyo class remap
{Car,Van,Car-Trailer}→car(0), {Pickup,Truck,Trailer,Bus}→truck(1),
train/val split, and the training notebook's augmentation recipe (mosaic,
mixup, copy_paste, affine, flips, HSV) as deterministic numpy host
transforms feeding fixed-shape batches. With the same seed the same
batches come out, bit for bit. Images decode through the port's own
``gio/decode.decode_rgb``.
"""

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# class remap of the Tokyo notebook (cell 2)
TOKYO_CLASS_REMAP = {
    "Car": 0, "Van": 0, "Car-Trailer": 0,
    "Pickup": 1, "Truck": 1, "Trailer": 1, "Bus": 1,
}
TOKYO_CLASS_NAMES = ("car", "truck")


@dataclass
class Sample:
    image_path: str
    boxes: np.ndarray        # [N, 5]: cls, cx, cy, w, h — normalized 0..1


def coco_to_yolo(coco_path: str,
                 class_remap: Optional[Dict[str, int]] = None
                 ) -> List[Sample]:
    """COCO instance JSON → samples with normalized cxcywh targets."""
    with open(coco_path) as f:
        coco = json.load(f)
    cats = {c["id"]: c["name"] for c in coco.get("categories", [])}
    images = {im["id"]: im for im in coco.get("images", [])}
    remap = class_remap or {}
    by_image: Dict[int, List[List[float]]] = {}
    for ann in coco.get("annotations", []):
        im = images.get(ann["image_id"])
        if im is None:
            continue
        name = cats.get(ann["category_id"], str(ann["category_id"]))
        if remap:
            if name not in remap:
                continue
            cls = remap[name]
        else:
            cls = ann["category_id"]
        x, y, w, h = ann["bbox"]           # COCO: xywh absolute, top-left
        cx = (x + w / 2) / im["width"]
        cy = (y + h / 2) / im["height"]
        by_image.setdefault(ann["image_id"], []).append(
            [cls, cx, cy, w / im["width"], h / im["height"]])
    base = os.path.dirname(os.path.abspath(coco_path))
    out = []
    for img_id, im in images.items():
        boxes = np.asarray(by_image.get(img_id, []),
                           dtype=np.float32).reshape(-1, 5)
        out.append(Sample(os.path.join(base, im["file_name"]), boxes))
    return out


def write_yolo_labels(samples: Sequence[Sample], label_dir: str) -> None:
    """Emit ultralytics-style .txt labels (one 'cls cx cy w h' row per box)."""
    os.makedirs(label_dir, exist_ok=True)
    for s in samples:
        stem = os.path.splitext(os.path.basename(s.image_path))[0]
        with open(os.path.join(label_dir, stem + ".txt"), "w") as f:
            for cls, cx, cy, w, h in s.boxes:
                f.write(f"{int(cls)} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}\n")


def train_val_split(samples: Sequence[Sample], n_train: int,
                    seed: int = 0) -> Tuple[List[Sample], List[Sample]]:
    """Deterministic split (the notebook used a fixed 80-image train set)."""
    idx = np.random.default_rng(seed).permutation(len(samples))
    train = [samples[i] for i in idx[:n_train]]
    val = [samples[i] for i in idx[n_train:]]
    return train, val


# --------------------------------------------------------- augmentations

def mosaic4(images: Sequence[np.ndarray], boxes: Sequence[np.ndarray],
            out_size: int, rng: np.random.Generator
            ) -> Tuple[np.ndarray, np.ndarray]:
    """4-image mosaic (ultralytics-style): random center, each quadrant
    filled from one image, boxes rescaled/clipped. boxes are [N,5] with
    normalized coords; output boxes are in output *pixels*."""
    s = out_size
    yc = int(rng.uniform(s * 0.35, s * 0.65))
    xc = int(rng.uniform(s * 0.35, s * 0.65))
    canvas = np.full((s, s, 3), 114, dtype=np.uint8)
    out_boxes = []
    quads = [(0, 0, xc, yc), (xc, 0, s, yc), (0, yc, xc, s), (xc, yc, s, s)]
    for (x1, y1, x2, y2), img, bxs in zip(quads, images, boxes):
        qh, qw = y2 - y1, x2 - x1
        ih, iw = img.shape[:2]
        # place the image's bottom-right region into the quadrant (simple,
        # deterministic variant of the random-crop placement)
        sy, sx = max(0, ih - qh), max(0, iw - qw)
        patch = img[sy:sy + qh, sx:sx + qw]
        canvas[y1:y1 + patch.shape[0], x1:x1 + patch.shape[1]] = patch
        if len(bxs):
            b = bxs.copy()
            # normalized → source pixels → shifted into canvas
            b[:, 1] = b[:, 1] * iw - sx + x1
            b[:, 2] = b[:, 2] * ih - sy + y1
            b[:, 3] = b[:, 3] * iw
            b[:, 4] = b[:, 4] * ih
            # clip boxes to the QUADRANT holding this image's pixels (not
            # the whole canvas — a box whose source pixels were cropped
            # away must not survive as a phantom label over a neighbor
            # quadrant's content), drop degenerate leftovers
            px2 = x1 + patch.shape[1]
            py2 = y1 + patch.shape[0]
            cx1 = np.clip(b[:, 1] - b[:, 3] / 2, x1, px2)
            cy1 = np.clip(b[:, 2] - b[:, 4] / 2, y1, py2)
            cx2 = np.clip(b[:, 1] + b[:, 3] / 2, x1, px2)
            cy2 = np.clip(b[:, 2] + b[:, 4] / 2, y1, py2)
            keep = (cx2 - cx1 > 2) & (cy2 - cy1 > 2)
            b = np.stack([b[:, 0], (cx1 + cx2) / 2, (cy1 + cy2) / 2,
                          cx2 - cx1, cy2 - cy1], axis=1)[keep]
            out_boxes.append(b)
    merged = (np.concatenate(out_boxes, 0) if out_boxes
              else np.zeros((0, 5), np.float32))
    return canvas, merged.astype(np.float32)


def mixup(img_a, boxes_a, img_b, boxes_b, rng: np.random.Generator,
          alpha: float = 32.0):
    """Beta-blended mixup; both box sets kept (ultralytics semantics)."""
    lam = float(rng.beta(alpha, alpha))
    img = (img_a.astype(np.float32) * lam
           + img_b.astype(np.float32) * (1 - lam)).astype(np.uint8)
    return img, np.concatenate([boxes_a, boxes_b], axis=0)


def hsv_jitter(img: np.ndarray, rng: np.random.Generator,
               gain: float = 0.2) -> np.ndarray:
    """Cheap brightness/saturation jitter without cv2."""
    f = 1.0 + rng.uniform(-gain, gain)
    mean = img.mean(axis=(0, 1), keepdims=True)
    sat = 1.0 + rng.uniform(-gain, gain)
    out = (img.astype(np.float32) - mean) * sat + mean * f
    return np.clip(out, 0, 255).astype(np.uint8)


def _ioa(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    """Intersection of `box` with each of `others`, over the OTHERS' area
    (ultralytics bbox_ioa — 'how much of the existing object would the
    paste cover')."""
    x1, y1, x2, y2 = box
    ox1 = others[:, 1] - others[:, 3] / 2
    oy1 = others[:, 2] - others[:, 4] / 2
    ox2 = others[:, 1] + others[:, 3] / 2
    oy2 = others[:, 2] + others[:, 4] / 2
    iw = np.maximum(0.0, np.minimum(x2, ox2) - np.maximum(x1, ox1))
    ih = np.maximum(0.0, np.minimum(y2, oy2) - np.maximum(y1, oy1))
    area = np.maximum((ox2 - ox1) * (oy2 - oy1), 1e-9)
    return iw * ih / area


def copy_paste(img: np.ndarray, boxes: np.ndarray,
               donor_img: np.ndarray, donor_boxes: np.ndarray,
               rng: np.random.Generator, *, max_paste: int = 8,
               max_overlap: float = 0.3, tries: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Copy-paste augmentation (notebook cell 14 trains with
    copy_paste=True — x_arch/01_train_tokyo.ipynb). Ultralytics pastes
    segment masks; with box-only labels the labeled pixel set IS the box
    rectangle, so the paste unit here is the donor's labeled rect.

    Both box sets are [N,5] cls,cx,cy,w,h in PIXELS of their own image.
    Each donor rect (up to max_paste, shuffled) is pasted at a uniformly
    random position where it covers no existing or already-pasted box by
    more than `max_overlap` of that box's area (so pastes never bury a
    real label); positions are retried `tries` times then the rect is
    skipped. Returns (new image, boxes with pasted labels appended).
    """
    if len(donor_boxes) == 0:
        return img, boxes
    h, w = img.shape[:2]
    out = img.copy()
    cur = boxes.copy()
    order = rng.permutation(len(donor_boxes))[:max_paste]
    for di in order:
        cls, cx, cy, bw, bh = donor_boxes[di]
        x1 = int(round(cx - bw / 2)); y1 = int(round(cy - bh / 2))
        x2 = int(round(cx + bw / 2)); y2 = int(round(cy + bh / 2))
        x1, x2 = max(0, x1), min(donor_img.shape[1], x2)
        y1, y2 = max(0, y1), min(donor_img.shape[0], y2)
        pw, ph = x2 - x1, y2 - y1
        if pw < 2 or ph < 2 or pw >= w or ph >= h:
            continue
        patch = donor_img[y1:y2, x1:x2]
        for _ in range(tries):
            px = int(rng.integers(0, w - pw))
            py = int(rng.integers(0, h - ph))
            cand = np.asarray([px, py, px + pw, py + ph], np.float32)
            if len(cur) and float(_ioa(cand, cur).max()) > max_overlap:
                continue
            out[py:py + ph, px:px + pw] = patch
            new = np.asarray([cls, px + pw / 2, py + ph / 2, pw, ph],
                             np.float32)
            cur = np.concatenate([cur, new[None]], axis=0)
            break
    return out, cur.astype(np.float32)


def random_scale_translate(img: np.ndarray, boxes: np.ndarray,
                           rng: np.random.Generator, *,
                           scale: float = 0.5, translate: float = 0.1,
                           fill: int = 114
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Random scale + translation (the affine part of ultralytics
    random_perspective with its default degrees=0/shear=0/perspective=0 —
    the hyperparameters the reference's checkpoints trained under; cell
    14 leaves them at defaults scale=0.5, translate=0.1).

    The image is resized by f ~ U(1−scale, 1+scale) and pasted on a
    same-size canvas (gray 114 fill, as upstream) with its center moved
    to U(0.5±translate)·size. Boxes (pixel cxcywh) are transformed,
    clipped, and filtered by upstream's box_candidates rule (≥2 px sides,
    ≥10% of the scaled area survives the clip).
    """
    from PIL import Image
    h, w = img.shape[:2]
    f = float(rng.uniform(1.0 - scale, 1.0 + scale))
    nw, nh = max(1, int(round(w * f))), max(1, int(round(h * f)))
    resized = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                     Image.BILINEAR))
    cx = rng.uniform(0.5 - translate, 0.5 + translate) * w
    cy = rng.uniform(0.5 - translate, 0.5 + translate) * h
    tx = int(round(cx - nw / 2))
    ty = int(round(cy - nh / 2))
    out = np.full_like(img, fill)
    sx1, sy1 = max(0, -tx), max(0, -ty)
    dx1, dy1 = max(0, tx), max(0, ty)
    cw = min(nw - sx1, w - dx1)
    ch = min(nh - sy1, h - dy1)
    if cw > 0 and ch > 0:
        out[dy1:dy1 + ch, dx1:dx1 + cw] = resized[sy1:sy1 + ch,
                                                  sx1:sx1 + cw]
    if not len(boxes):
        return out, boxes
    fx, fy = nw / w, nh / h          # the realized per-axis factor
    x1 = (boxes[:, 1] - boxes[:, 3] / 2) * fx + tx
    y1 = (boxes[:, 2] - boxes[:, 4] / 2) * fy + ty
    x2 = (boxes[:, 1] + boxes[:, 3] / 2) * fx + tx
    y2 = (boxes[:, 2] + boxes[:, 4] / 2) * fy + ty
    area0 = np.maximum((x2 - x1) * (y2 - y1), 1e-9)
    x1, x2 = np.clip(x1, 0, w), np.clip(x2, 0, w)
    y1, y2 = np.clip(y1, 0, h), np.clip(y2, 0, h)
    bw, bh = x2 - x1, y2 - y1
    keep = (bw > 2) & (bh > 2) & (bw * bh / area0 > 0.1)
    nb = np.stack([boxes[:, 0], (x1 + x2) / 2, (y1 + y2) / 2, bw, bh],
                  axis=1)[keep]
    return out, np.ascontiguousarray(nb, np.float32)


def flip_boxes(img: np.ndarray, boxes: np.ndarray, *, lr: bool = False,
               ud: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal/vertical flip of an image and its pixel-space cxcywh
    boxes (the ultralytics fliplr/flipud transforms — defaults
    fliplr=0.5/flipud=0.0 in the recipe the reference trained under)."""
    h, w = img.shape[:2]
    b = boxes.copy()
    if lr:
        img = img[:, ::-1]
        if len(b):
            b[:, 1] = w - b[:, 1]
    if ud:
        img = img[::-1]
        if len(b):
            b[:, 2] = h - b[:, 2]
    return np.ascontiguousarray(img), b


@dataclass
class LoaderConfig:
    image_size: int = 640
    batch_size: int = 8
    max_targets: int = 128
    mosaic: float = 1.0          # probability (notebook: mosaic=1.0)
    mixup: float = 0.5           # probability (notebook: mixup=0.5)
    hsv: float = 0.5
    # the rest of the notebook recipe (cell 14 / ultralytics defaults);
    # OFF by default to preserve the validated round-1 recipe exactly
    # (the knobs draw no rng when 0, so existing streams are unchanged)
    copy_paste: float = 0.0      # probability (notebook: copy_paste=True)
    fliplr: float = 0.0          # probability (ultralytics default 0.5)
    flipud: float = 0.0          # probability (ultralytics default 0.0)
    scale: float = 0.0           # affine scale range (upstream default 0.5)
    translate: float = 0.0       # affine translate range (upstream 0.1)
    # disable mosaic/mixup/copy_paste for the last N epochs (ultralytics
    # close_mosaic, default 10 upstream): the final epochs see clean
    # single images so BN stats and the detector settle on the real data
    # distribution. Needs total_epochs (pipeline.train.fit sets it).
    close_mosaic: int = 0
    seed: int = 0


class DetectionLoader:
    """Deterministic host-side loader → (images [B,S,S,3] u8,
    targets [B,T,5] with cls=−1 padding, in input pixels)."""

    def __init__(self, samples: Sequence[Sample], cfg: LoaderConfig,
                 decode_fn=None, train: bool = True):
        self.samples = list(samples)
        self.cfg = cfg
        self.train = train
        self._decode = decode_fn or self._decode_default

    @staticmethod
    def _decode_default(path: str) -> np.ndarray:
        from aerial_image_recognition_tpu_torch.gio.decode import decode_rgb
        with open(path, "rb") as f:
            arr = decode_rgb(f.read())  # native libjpeg path, PIL fallback
        if arr is None:
            raise ValueError(f"undecodable image {path!r}")
        return arr

    def _load_resized(self, sample: Sample, size: int):
        from PIL import Image
        img = self._decode(sample.image_path)
        if img.shape[0] != size or img.shape[1] != size:
            img = np.asarray(
                Image.fromarray(img).resize((size, size), Image.BILINEAR),
                dtype=np.uint8)
        return img, sample.boxes

    def epoch(self, epoch_idx: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + epoch_idx)
        order = rng.permutation(len(self.samples))
        s = cfg.image_size
        # ultralytics close_mosaic window: the composite augmentations
        # (mosaic/mixup/copy_paste) switch off for the final epochs;
        # flips/hsv stay on (matching upstream's close_dataloader_mosaic)
        total = getattr(self, "total_epochs", 0)
        closing = (cfg.close_mosaic > 0 and total > 0
                   and epoch_idx >= total - cfg.close_mosaic)
        mosaic_p = 0.0 if closing else cfg.mosaic
        mixup_p = 0.0 if closing else cfg.mixup
        paste_p = 0.0 if closing else cfg.copy_paste
        batch_imgs, batch_tgts = [], []
        for i in order:
            if self.train and rng.random() < mosaic_p:
                picks = [self.samples[j] for j in
                         rng.integers(0, len(self.samples), 3)]
                imgs, bxs = zip(*[self._load_resized(x, s)
                                  for x in [self.samples[i]] + list(picks)])
                img, boxes = mosaic4(imgs, bxs, s, rng)
            else:
                img, nb = self._load_resized(self.samples[i], s)
                boxes = nb.copy()
                if len(boxes):
                    boxes[:, 1:] *= s       # normalized → pixels
            # upstream transform order (ultralytics v8_transforms):
            # Mosaic → CopyPaste → RandomPerspective(affine) → MixUp →
            # flips/HSV — pasted objects receive the affine and mixup
            # blending like everything else
            if (self.train and paste_p > 0.0
                    and rng.random() < paste_p
                    and len(self.samples) > 1):
                j = int(rng.integers(0, len(self.samples)))
                dimg, dnb = self._load_resized(self.samples[j], s)
                db = dnb.copy()
                if len(db):
                    db[:, 1:] *= s
                img, boxes = copy_paste(img, boxes, dimg, db, rng)
            if self.train and (cfg.scale > 0.0 or cfg.translate > 0.0):
                img, boxes = random_scale_translate(
                    img, boxes, rng, scale=cfg.scale,
                    translate=cfg.translate)
            if self.train and rng.random() < mixup_p and len(self.samples) > 1:
                j = int(rng.integers(0, len(self.samples)))
                img2, nb2 = self._load_resized(self.samples[j], s)
                b2 = nb2.copy()
                if len(b2):
                    b2[:, 1:] *= s
                img, boxes = mixup(img, boxes, img2, b2, rng)
            if self.train and cfg.fliplr > 0.0 and rng.random() < cfg.fliplr:
                img, boxes = flip_boxes(img, boxes, lr=True)
            if self.train and cfg.flipud > 0.0 and rng.random() < cfg.flipud:
                img, boxes = flip_boxes(img, boxes, ud=True)
            if self.train and rng.random() < cfg.hsv:
                img = hsv_jitter(img, rng)

            tgt = np.full((cfg.max_targets, 5), -1.0, dtype=np.float32)
            n = min(len(boxes), cfg.max_targets)
            tgt[:n] = boxes[:n]
            batch_imgs.append(img)
            batch_tgts.append(tgt)
            if len(batch_imgs) == cfg.batch_size:
                yield (np.stack(batch_imgs), np.stack(batch_tgts))
                batch_imgs, batch_tgts = [], []
        if not self.train and batch_imgs:
            # eval must see EVERY sample: yield the ragged tail (one extra
            # compile for the tail shape; pad targets are already -1 so
            # metrics ignore nothing real). Training keeps static shapes.
            yield (np.stack(batch_imgs), np.stack(batch_tgts))
        # training drops the ragged tail (static shapes)
