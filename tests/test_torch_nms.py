"""The port's NMS against the JAX package, bit for bit.

Two comparisons on the same numpy inputs:
  * the port's plain suppression (the CPU form of the CUDA kernel's
    contract) against the Pallas kernel ``nms_suppress_pallas`` run in
    interpret mode: picks (idx, and cls wherever the Pallas kernel writes
    real classes) bit-identical, conf exactly equal;
  * the port's ``batched_nms`` against the JAX ``batched_nms`` scan path:
    valid and classes bit-identical, scores and boxes exactly equal.
The cases are those of ``tests/test_pallas_nms.py`` plus exact score ties.

Then the other forms: the fixpoint suppression gives the plain version's
picks bit for bit; box voting agrees with the JAX ``box_voting`` within
1e-3 px (a weighted f32 sum over up to 256 candidates, summed in another
order) and with the numpy oracle of ``tests/test_pallas_nms.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.ops.nms import batched_nms as jax_nms
from aerial_image_recognition_tpu.ops.pallas_kernels import (
    nms_suppress_pallas)
from aerial_image_recognition_tpu_torch.ops.nms import (
    _suppress_fixpoint, _suppress_plain, batched_nms, iou_matrix)
from aerial_image_recognition_tpu_torch.ops.nms_kernel import nms_suppress

torch.set_num_threads(2)        # xdist workers share the cores

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _clustered(rng, b, n, nc):
    """test_pallas_nms.py's problem: half the boxes jittered copies of the
    other half, so suppression has real work."""
    boxes = np.stack([
        rng.uniform(0, 640, (b, n)), rng.uniform(0, 640, (b, n)),
        rng.uniform(5, 60, (b, n)), rng.uniform(5, 60, (b, n))],
        axis=-1).astype(np.float32)
    boxes[:, n // 2:] = boxes[:, : n // 2] \
        + rng.normal(0, 3, (b, n // 2, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, nc)).astype(np.float32)
    return boxes, scores


def _ties(rng, b, n, nc):
    """Scores on a coarse grid (many exact ties) and exact duplicate
    boxes: tie order must go to the lowest index everywhere."""
    boxes, _ = _clustered(rng, b, n, nc)
    boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]
    scores = (rng.integers(0, 8, (b, n, nc)) / 8.0).astype(np.float32)
    return boxes, scores


def _empty(rng, b, n, nc):
    return (np.zeros((b, n, 4), np.float32),
            np.zeros((b, n, nc), np.float32))


def _odd(rng, b, n, nc):
    boxes = rng.uniform(0, 600, (b, n, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(5, 40, (b, n, 2))
    return boxes, rng.uniform(0, 1, (b, n, nc)).astype(np.float32)


# (problem, batch, anchors, nc, class_aware, max_det, pre_topk)
CASES = {
    "clustered-nc1": (_clustered, 3, 300, 1, True, 64, 256),
    "clustered-nc3-aware": (_clustered, 3, 300, 3, True, 64, 256),
    "clustered-nc3-agnostic": (_clustered, 3, 300, 3, False, 64, 256),
    "ties-nc1": (_ties, 4, 200, 1, True, 64, 128),
    "ties-nc3-aware": (_ties, 4, 200, 3, True, 32, 128),
    "empty": (_empty, 2, 128, 1, True, 16, 128),
    "odd-batch6": (_odd, 6, 64, 1, True, 16, 64),
    "odd-batch7": (_odd, 7, 64, 1, True, 16, 64),
    "fewer-candidates-than-slots": (_odd, 2, 12, 1, True, 16, 64),
}


def _problem(name):
    make, b, n, nc, aware, d, k = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    boxes, scores = make(rng, b, n, nc)
    return boxes, scores, dict(num_classes=nc, class_aware=aware,
                               max_det=d, pre_topk=k)


def _preselected(boxes, scores, kw, conf=0.3):
    """The suppression kernel's inputs, preselected in numpy: top-K by
    best-class score (stable, lowest index first on ties), −1 below conf."""
    best = scores.max(-1)
    cls = scores.argmax(-1).astype(np.int32)
    k = min(kw["pre_topk"], boxes.shape[1])
    idx = np.argsort(-best, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(best, idx, 1)
    boxes_t = np.take_along_axis(boxes, idx[..., None], 1).transpose(0, 2, 1)
    masked = np.where(top >= np.float32(conf), top, np.float32(-1.0))
    return (np.ascontiguousarray(boxes_t), masked.astype(np.float32),
            np.take_along_axis(cls, idx, 1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_suppression_matches_pallas_kernel(name):
    boxes, scores, kw = _problem(name)
    boxes_t, masked, cls = _preselected(boxes, scores, kw)
    aware = kw["class_aware"] and kw["num_classes"] > 1
    want = nms_suppress_pallas(
        jnp.asarray(boxes_t), jnp.asarray(masked), jnp.asarray(cls),
        iou_threshold=0.45, max_det=kw["max_det"], class_aware=aware,
        interpret=True)
    args = (torch.from_numpy(boxes_t), torch.from_numpy(masked),
            torch.from_numpy(cls))
    got = _suppress_plain(*args, iou_threshold=0.45, max_det=kw["max_det"],
                          class_aware=aware)
    # the wrapper takes the plain version for CPU tensors, and only then
    wrapped = nms_suppress(*args, iou_threshold=0.45, max_det=kw["max_det"],
                           class_aware=aware)
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)
    idx, conf, pcls = (t.numpy() for t in got)
    assert idx.dtype == np.int32 and pcls.dtype == np.int32
    np.testing.assert_array_equal(idx, np.asarray(want[0]))
    np.testing.assert_array_equal(conf, np.asarray(want[1]))
    if aware or kw["num_classes"] == 1:
        # class-agnostic Pallas writes class 0; the port writes the pick's
        np.testing.assert_array_equal(pcls, np.asarray(want[2]))
    np.testing.assert_array_equal(pcls, np.take_along_axis(cls, idx, 1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_nms_matches_scan(name):
    boxes, scores, kw = _problem(name)
    common = dict(conf_threshold=0.3, iou_threshold=0.45, **kw)
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), use_pallas=False,
                   preselect="exact", **common)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      **common)
    assert got.valid.dtype == torch.bool and got.classes.dtype == torch.int32
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    # 'approx' is the exact preselect in the port
    approx = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         preselect="approx", **common)
    assert torch.equal(approx.valid, got.valid)


def test_nms_golden_fixture():
    """The seeded problem of test_golden_regression.test_nms_golden against
    its recorded fixture and the JAX scan."""
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 640, (1, 200, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (1, 200, 1)).astype(np.float32)
    kw = dict(num_classes=1, conf_threshold=0.3, iou_threshold=0.45,
              max_det=32, pre_topk=128)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), use_pallas=False,
                   **kw)
    with np.load(os.path.join(FIXTURE_DIR, "nms_s0.npz")) as ref:
        np.testing.assert_array_equal(got.valid.numpy()[0].astype(np.int8),
                                      ref["valid"])
        np.testing.assert_allclose(got.scores.numpy()[0], ref["scores"],
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))


def test_iou_matrix_and_options():
    from aerial_image_recognition_tpu.ops.nms import (
        iou_matrix as jax_iou_matrix)
    rng = np.random.default_rng(3)
    a, b = _odd(rng, 1, 40, 1)[0][0], _odd(rng, 1, 30, 1)[0][0]
    np.testing.assert_array_equal(
        iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_iou_matrix(jnp.asarray(a), jnp.asarray(b))))
    boxes = torch.zeros((1, 8, 4))
    scores = torch.zeros((1, 8, 1))
    with pytest.raises(ValueError, match="preselect"):
        batched_nms(boxes, scores, num_classes=1, preselect="fast")
    with pytest.raises(ValueError, match="unknown nms suppression"):
        batched_nms(boxes, scores, num_classes=1, suppression="fixpont")


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixpoint_picks_match_plain_suppression(name):
    boxes, scores, kw = _problem(name)
    boxes_t, masked, cls = _preselected(boxes, scores, kw)
    aware = kw["class_aware"] and kw["num_classes"] > 1
    args = (torch.from_numpy(boxes_t), torch.from_numpy(masked),
            torch.from_numpy(cls))
    skw = dict(iou_threshold=0.45, max_det=kw["max_det"], class_aware=aware)
    want = _suppress_plain(*args, **skw)
    got = _suppress_fixpoint(*args, **skw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    valid = want[1] >= 0.3
    if name != "empty":
        assert valid.any()
    assert torch.equal(got[1] >= 0.3, valid)
    assert torch.equal(got[1], want[1])               # conf, all slots
    for g, w in zip(got, want):                       # idx, conf, cls
        assert torch.equal(g[valid], w[valid])


@pytest.mark.parametrize("suppression", [None, "pallas", "scan", "fixpoint"])
@pytest.mark.parametrize("name", ["clustered-nc3-aware", "ties-nc1",
                                  "fewer-candidates-than-slots"])
def test_batched_nms_suppression_names(name, suppression):
    boxes, scores, kw = _problem(name)
    common = dict(conf_threshold=0.3, iou_threshold=0.45, **kw)
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), use_pallas=False,
                   preselect="exact",
                   suppression="fixpoint" if suppression == "fixpoint"
                   else "scan", **common)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      suppression=suppression, **common)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))


@pytest.mark.parametrize("suppression,calls", [(None, 1), ("pallas", 1),
                                               ("scan", 1), ("fixpoint", 0)])
def test_serial_suppression_names_go_through_the_kernel_wrapper(
        monkeypatch, suppression, calls):
    """'scan' is a name kept for config compatibility, not a way around the
    kernel: like None and 'pallas' it calls ``nms_suppress``, which launches
    the CUDA kernel for tensors on the card."""
    from aerial_image_recognition_tpu_torch.ops import nms_kernel
    seen = []
    real = nms_kernel.nms_suppress

    def spy(*args, **kw):
        seen.append(args[0].device.type)
        return real(*args, **kw)

    monkeypatch.setattr(nms_kernel, "nms_suppress", spy)
    boxes, scores, kw = _problem("clustered-nc1")
    batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                suppression=suppression, conf_threshold=0.3,
                iou_threshold=0.45, **kw)
    assert len(seen) == calls


def _voting_oracle(det, cand_boxes, cand_scores, cand_cls, vote_iou, conf,
                   class_aware):
    """The numpy reference of tests/test_pallas_nms.py: score-weighted mean
    (f64) of IoU>=gate same-class candidates above conf, per kept box."""
    from aerial_image_recognition_tpu.ops.metrics import iou_xywh
    out = np.array(det.boxes, np.float64)
    for b in range(out.shape[0]):
        for d in range(out.shape[1]):
            if not det.valid[b, d]:
                continue
            ious = iou_xywh(np.asarray(det.boxes[b, d])[None],
                            np.asarray(cand_boxes[b]))[0]
            m = (ious >= vote_iou) & (np.asarray(cand_scores[b]) >= conf)
            if class_aware:
                m &= np.asarray(cand_cls[b]) == int(det.classes[b, d])
            w = np.where(m, np.asarray(cand_scores[b], np.float64), 0.0)
            if w.sum() > 0:
                out[b, d] = (w[:, None]
                             * np.asarray(cand_boxes[b], np.float64)
                             ).sum(0) / w.sum()
    return out.astype(np.float32)


@pytest.mark.parametrize("name", ["clustered-nc1", "clustered-nc3-aware",
                                  "clustered-nc3-agnostic", "ties-nc1"])
def test_box_voting_matches_jax_and_numpy_oracle(name):
    boxes, scores, kw = _problem(name)
    common = dict(conf_threshold=0.3, iou_threshold=0.45, **kw)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    plain = batched_nms(tb, ts, **common)
    voted = batched_nms(tb, ts, vote_iou=0.5, **common)
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), use_pallas=False,
                   preselect="exact", vote_iou=0.5, **common)
    # scores, classes and validity pass through untouched
    assert torch.equal(voted.valid, plain.valid)
    assert torch.equal(voted.scores, plain.scores)
    assert torch.equal(voted.classes, plain.classes)
    np.testing.assert_array_equal(voted.valid.numpy(),
                                  np.asarray(want.valid))
    np.testing.assert_allclose(voted.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3, rtol=0)
    bt, masked, cls = _preselected(boxes, scores, kw)
    np_det = type("D", (), dict(boxes=plain.boxes.numpy(),
                                valid=plain.valid.numpy(),
                                classes=plain.classes.numpy()))
    oracle = _voting_oracle(
        np_det, bt.transpose(0, 2, 1), masked, cls, 0.5, 0.3,
        class_aware=kw["class_aware"] and kw["num_classes"] > 1)
    v = voted.valid.numpy()
    np.testing.assert_allclose(voted.boxes.numpy()[v], oracle[v],
                               rtol=1e-4, atol=1e-3)
    # at least one box moved (duplicate-heavy problem); invalid stay zero
    assert np.abs(voted.boxes.numpy()[v] - plain.boxes.numpy()[v]).max() > 1e-3
    assert not voted.boxes.numpy()[~v].any()


def test_box_voting_isolated_box_unmoved():
    boxes = torch.tensor([[[100.0, 100.0, 20.0, 10.0]]
                          + [[500.0 + 40 * k, 500.0, 8.0, 8.0]
                             for k in range(7)]])
    scores = torch.tensor(
        np.concatenate([[0.9], np.full(7, 0.01)])[None, :, None],
        dtype=torch.float32)
    kw = dict(num_classes=1, conf_threshold=0.3, max_det=8, pre_topk=8)
    plain = batched_nms(boxes, scores, **kw)
    voted = batched_nms(boxes, scores, vote_iou=0.5, **kw)
    np.testing.assert_allclose(voted.boxes.numpy(), plain.boxes.numpy(),
                               atol=1e-5)


def test_box_voting_merges_toward_weighted_mean():
    boxes = torch.tensor([[[100.0, 100.0, 20.0, 20.0],
                           [104.0, 100.0, 20.0, 20.0]]])
    scores = torch.tensor([[[0.6], [0.4]]])
    kw = dict(num_classes=1, conf_threshold=0.3, iou_threshold=0.45,
              max_det=4, pre_topk=2)
    plain = batched_nms(boxes, scores, **kw)
    voted = batched_nms(boxes, scores, vote_iou=0.5, **kw)
    assert int(plain.valid.sum()) == 1          # the pair was suppressed
    want_cx = (0.6 * 100.0 + 0.4 * 104.0) / 1.0
    np.testing.assert_allclose(voted.boxes.numpy()[0, 0],
                               [want_cx, 100.0, 20.0, 20.0], rtol=1e-5)
