"""The port's losses (``ops/losses.py``) against the JAX package's.

The same raw head maps and padded targets, made from a numpy seed, go
through both: YOLOv7 (nc 1 and 2, binary and IoU-scored objectness, a
positive weight), YOLOv8 (nc 2) and XUnet. The targets hold boxes that
share a cell with another, a box that matches no anchor (and no size band
of its own), a box centred in the last cell of every map — where the
reference's unmatched rows land when its −1 index wraps — and padding.

Tolerances: losses and their parts rtol 1e-5; gradients with respect to
the maps within 1e-5 of their largest magnitude (f32 sums in another
order); the scattered target maps equal (tolerance 0; IoU-scored
objectness targets, which are f32 IoUs, within rtol 1e-6 at the same
cells).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.ops import losses as JL
from aerial_image_recognition_tpu_torch.models.yolov7 import (
    ANCHORS_TINY, STRIDES)
from aerial_image_recognition_tpu_torch.models.yolov8 import REG_MAX
from aerial_image_recognition_tpu_torch.ops import losses as PL

torch.set_num_threads(2)
SIZE = 64


def _targets(rng, nc, b=2, t=12):
    tg = np.full((b, t, 5), -1.0, np.float32)
    for bi in range(b):
        for i in range(7):
            tg[bi, i] = (rng.integers(0, nc), rng.uniform(0, SIZE),
                         rng.uniform(0, SIZE), rng.uniform(4, 40),
                         rng.uniform(4, 40))
    tg[0, 7] = tg[0, 0] * np.float32([1, 1, 1, 0.9, 1.1])   # same cell
    tg[0, 8] = (0, 31.0, 33.0, 30.0, 30.0)
    tg[0, 9] = (0, 30.0, 34.0, 10.0, 9.0)                    # shares a cell
    tg[1, 7] = (0, 30.0, 30.0, 1000.0, 1.0)                  # no anchor
    tg[1, 8] = (nc - 1, SIZE - 1.0, SIZE - 1.0, 12.0, 14.0)  # last cell
    tg[1, 9] = (0, SIZE - 2.0, SIZE - 3.0, 300.0, 2.0)       # last, unmatched
    return tg


def _maps(rng, per_cell, b=2):
    return [rng.normal(0, 2, (b, SIZE // s, SIZE // s, per_cell))
            .astype(np.float32) for s in STRIDES]


def _grads(jfn, pfn, maps):
    """(jax loss, jax metrics, jax grads, port loss, port metrics, port
    grads) of the same maps."""
    (jl, jm), jg = jax.value_and_grad(jfn, has_aux=True)(
        [jnp.asarray(m) for m in maps])
    pt = [torch.tensor(m, requires_grad=True) for m in maps]
    pl, pm = pfn(pt)
    pl.backward()
    pm = {k: v.detach() if isinstance(v, torch.Tensor) else v
          for k, v in pm.items()}
    return jl, jm, jg, pl.detach(), pm, [p.grad.numpy() for p in pt]


def _close(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               atol=1e-7, err_msg=what)


def _grads_close(pg, jg):
    for got, want in zip(pg, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("nc,kw", [
    (1, {}), (2, {}), (2, {"obj_iou_scored": True}),
    (1, {"obj_pos_weight": 5.0}), (2, {"anchor_t": 2.0, "box_w": 0.1}),
], ids=["nc1", "nc2", "iou-scored", "pos-weight", "anchor-t"])
def test_yolov7_loss_equals_jax(nc, kw):
    rng = np.random.default_rng(nc)
    tg = _targets(rng, nc)
    maps = _maps(rng, 3 * (5 + nc))
    jl, jm, jg, pl, pm, pg = _grads(
        lambda o: JL.yolov7_loss(o, jnp.asarray(tg), ANCHORS_TINY, nc, **kw),
        lambda o: PL.yolov7_loss(o, torch.tensor(tg), ANCHORS_TINY, nc,
                                 **kw), maps)
    _close(pl, jl, "loss")
    for k in ("box", "obj", "cls"):
        _close(pm[k], jm[k], k)
    _grads_close(pg, jg)


def _jax_obj_targets(tg, nc, obj_iou_scored, maps):
    """The reference's objectness target maps, by its own expressions
    (``ops/losses.py:83-125``): −1 indices into ``.at[].max(mode="drop")``."""
    tg = jnp.asarray(tg)
    twh, txy, tvalid = tg[..., 3:5], tg[..., 1:3], tg[..., 0] >= 0
    out = []
    for raw, anc, s in zip(maps, ANCHORS_TINY, STRIDES):
        b, h, w, _ = raw.shape
        p = jnp.asarray(raw).reshape(b, h, w, 3, 5 + nc)
        anc_a = jnp.asarray(anc, dtype=jnp.float32)
        ratio = twh[..., None, :] / anc_a[None, None]
        ratio = jnp.maximum(ratio, 1.0 / (ratio + 1e-9))
        match = (jnp.max(ratio, axis=-1) < 4.0) & tvalid[..., None]
        cell = jnp.floor(txy / s)
        cx = jnp.clip(cell[..., 0].astype(jnp.int32), 0, w - 1)
        cy = jnp.clip(cell[..., 1].astype(jnp.int32), 0, h - 1)
        bi = jnp.arange(b)[:, None, None]
        ki = jnp.arange(3)[None, None, :]
        mf = match.astype(jnp.float32)
        if obj_iou_scored:
            pm = p[bi, cy[..., None], cx[..., None], ki]
            sig = jax.nn.sigmoid(pm)
            pxy = (sig[..., 0:2] * 2.0 - 0.5
                   + jnp.stack([cx, cy], -1)[..., None, :]) * s
            pwh = (sig[..., 2:4] * 2.0) ** 2 * anc_a[None, None]
            tbox = jnp.concatenate([txy, twh], -1)[..., None, :] \
                * jnp.ones((1, 1, 3, 1))
            iou = JL.ciou(jnp.concatenate([pxy, pwh], -1), tbox)
            score = jnp.clip(iou, 0.0, 1.0) * mf
        else:
            score = mf
        flat_idx = ((bi * h + cy[..., None]) * w + cx[..., None]) * 3 + ki
        flat_idx = jnp.where(match, flat_idx, -1)
        tobj = jnp.zeros((b * h * w * 3,), jnp.float32).at[
            flat_idx.reshape(-1)].max(score.reshape(-1), mode="drop")
        out.append(np.asarray(tobj.reshape(b, h, w, 3)))
    return out


@pytest.mark.parametrize("obj_iou_scored", [False, True],
                         ids=["binary", "iou-scored"])
def test_yolov7_target_maps_equal_jax(obj_iou_scored):
    rng = np.random.default_rng(7)
    nc = 2
    tg = _targets(rng, nc)
    maps = _maps(rng, 3 * (5 + nc))
    want = _jax_obj_targets(tg, nc, obj_iou_scored, maps)
    _, m = PL.yolov7_loss([torch.tensor(x) for x in maps], torch.tensor(tg),
                          ANCHORS_TINY, nc, obj_iou_scored=obj_iou_scored,
                          return_targets=True)
    for got, w in zip(m["obj_targets"], want):
        # the same cells; IoU-scored values are f32 IoUs (within an ULP)
        np.testing.assert_array_equal(got.numpy() > 0, w > 0)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6 if
                                   obj_iou_scored else 0, atol=0)
    # the last cell of P3 holds a real positive, which the reference's
    # wrapped −1 rows met with a max against 0
    assert want[0][1, -1, -1].max() > 0


def test_yolov8_loss_and_target_maps_equal_jax():
    rng = np.random.default_rng(8)
    nc = 2
    tg = _targets(rng, nc)
    maps = _maps(rng, 4 * REG_MAX + nc)
    jl, jm, jg, pl, pm, pg = _grads(
        lambda o: JL.yolov8_loss(o, jnp.asarray(tg), nc),
        lambda o: PL.yolov8_loss(o, torch.tensor(tg), nc,
                                 return_targets=True), maps)
    _close(pl, jl, "loss")
    for k in ("box", "dfl", "cls"):
        _close(pm[k], jm[k], k)
    _grads_close(pg, jg)
    # the class target maps, by the reference's expressions
    # (ops/losses.py:160-226)
    t = jnp.asarray(tg)
    size = jnp.sqrt(jnp.maximum(t[..., 3] * t[..., 4], 1e-6))
    for li, (raw, s, got) in enumerate(zip(maps, STRIDES,
                                           pm["cls_targets"])):
        b, h, w, _ = raw.shape
        lo = 0.0 if li == 0 else 2.0 * s
        hi = jnp.inf if li == 2 else 16.0 * s
        match = (t[..., 0] >= 0) & (size >= lo) & (size < hi)
        cell = jnp.floor(t[..., 1:3] / s)
        cx = jnp.clip(cell[..., 0].astype(jnp.int32), 0, w - 1)
        cy = jnp.clip(cell[..., 1].astype(jnp.int32), 0, h - 1)
        onehot = jax.nn.one_hot(jnp.maximum(t[..., 0], 0).astype(jnp.int32),
                                nc)
        flat_idx = jnp.where(match, (jnp.arange(b)[:, None] * h + cy) * w
                             + cx, -1)
        want = jnp.zeros((b * h * w, nc)).at[flat_idx.reshape(-1)].max(
            onehot.reshape(-1, nc) * match.reshape(-1, 1), mode="drop")
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).reshape(b, h, w, nc))


def test_xunet_loss_equals_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(0, 2, (2, 32, 32, 1)).astype(np.float32)
    masks = (rng.uniform(size=(2, 32, 32, 1)) > 0.6).astype(np.float32)
    jl, jm, jg, pl, pm, pg = _grads(
        lambda o: JL.xunet_loss(o[0], jnp.asarray(masks)),
        lambda o: PL.xunet_loss(o[0], torch.tensor(masks)), [logits])
    _close(pl, jl, "loss")
    for k in ("bce", "dice"):
        _close(pm[k], jm[k], k)
    _grads_close(pg, jg)


def test_kinks_take_the_reference_subgradient():
    """The reference's subgradients at the kinks: ``jnp.maximum`` splits a
    tie's gradient in half and ``jnp.abs`` has derivative +1 at 0, so a
    logit of exactly 0 (a dead ReLU trunk under a zero bias) gets −y from
    the BCE; touching boxes split the overlap's gradient."""
    logits = np.zeros((1, 4, 4, 1), np.float32)
    logits[0, 0, :2, 0] = (1.5, -2.0)
    masks = np.zeros((1, 4, 4, 1), np.float32)
    masks[0, 1:3, 1:3] = 1.0
    jl, jm, jg, pl, pm, pg = _grads(
        lambda o: JL.xunet_loss(o[0], jnp.asarray(masks)),
        lambda o: PL.xunet_loss(o[0], torch.tensor(masks)), [logits])
    np.testing.assert_allclose(pg[0], np.asarray(jg[0]), rtol=1e-6,
                               atol=1e-9)
    a = np.float32([[10.0, 10.0, 4.0, 4.0]])
    b = np.float32([[14.0, 10.0, 4.0, 4.0]])                 # touching
    ja = jax.grad(lambda x: JL.ciou(x, jnp.asarray(b)).sum())(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    PL.ciou(ta, torch.tensor(b)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-7)


def test_ciou_and_bce_equal_jax():
    rng = np.random.default_rng(10)
    a = np.abs(rng.normal(20, 8, (64, 4))).astype(np.float32)
    b = np.abs(rng.normal(20, 8, (64, 4))).astype(np.float32)
    np.testing.assert_allclose(
        PL.ciou(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(JL.ciou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5,
        atol=1e-6)
    lg = rng.normal(0, 30, 256).astype(np.float32)
    lab = rng.uniform(size=256).astype(np.float32)
    np.testing.assert_allclose(
        PL.bce_logits(torch.tensor(lg), torch.tensor(lab)).numpy(),
        np.asarray(JL.bce_logits(jnp.asarray(lg), jnp.asarray(lab))),
        rtol=1e-6, atol=1e-6)
    # alpha is detached: the gradient of the aspect term flows through v
    # alone, as the reference's stop_gradient
    ja = jax.grad(lambda x: JL.ciou(x, jnp.asarray(b)).sum())(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    PL.ciou(ta, torch.tensor(b)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), rtol=1e-4,
                               atol=1e-6)


def test_scatter_max_masks_out_unmatched_rows():
    idx = torch.tensor([[3, 1], [5, 3]])
    match = torch.tensor([[True, False], [True, True]])
    vals = torch.tensor([[0.25, 0.0], [0.5, 0.75]])
    got = PL.scatter_max(6, idx, vals, match)
    assert got.tolist() == [0.0, 0.0, 0.0, 0.75, 0.0, 0.5]
    onehot = torch.tensor([[[1.0, 0.0], [0.0, 0.0]], [[0.0, 1.0],
                                                       [1.0, 0.0]]])
    got = PL.scatter_max(6, idx, onehot, match)
    assert got[3].tolist() == [1.0, 0.0] and got[5].tolist() == [0.0, 1.0]
    assert got[1].tolist() == [0.0, 0.0]
