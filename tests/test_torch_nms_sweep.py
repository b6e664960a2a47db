"""The CUDA NMS kernel's control flow, modelled in numpy, against the plain
suppression.

``csrc/nms_suppress.cu`` cannot run without a card, so its algorithm is held
here: ``kernel_model`` mirrors the kernel step by step for one image — the
load (corners and area in f32, the reference's operation order), the vote
(row non-increasing and >= −1), the chunks of 32 candidates with one step
each, a thread's 32 bits against its own chunk (first "do the boxes
intersect", then the full test for those that do), the chunk's own warp
settling it by find-first-set and ballots, the list of picks against which
the alive candidates of later chunks then test their boxes, the end at the
last chunk with an alive candidate or at ``max_det`` picks, the tail fill
(0, −1, cls[0]), and the general path as
explicit argmax rounds — and must give ``ops/nms._suppress_plain``'s output.

Tolerance is 0 everywhere: idx and cls are integer picks, and conf is a
copy of an input score (or the constant −1), never a computed float. The
IoU that decides a pick is computed in f32 with IEEE operations in the same
order on both sides, so even a candidate exactly at the threshold falls the
same way.

Inputs: the nine cases of ``tests/test_torch_nms.py`` after its numpy
preselect; the twelve cases of ``chip_smoke.py`` (``NMS_CASES`` and
``nms_inputs`` are imported from it — the one source of those generators —
at a small batch); and a hypothesis property with score ties, exact
duplicate boxes, sorted or unsorted rows, both class modes and thresholds
from below 0 to 1.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from aerial_image_recognition_tpu_torch.ops.nms import (
    _suppress_plain, batched_nms)
from aerial_image_recognition_tpu_torch.ops import nms_kernel

from test_torch_nms import CASES, _preselected, _problem

torch.set_num_threads(2)        # xdist workers share the cores

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
SMOKE_CASES = {c[0]: c for c in chip_smoke.NMS_CASES}

F = np.float32


def _ffs(word: int) -> int:
    """CUDA's __ffs: 1-based position of the lowest set bit, 0 for 0."""
    return (word & -word).bit_length()


def _ballot(flags) -> int:
    """__ballot_sync over one warp: bit l is lane l's predicate."""
    return sum(1 << lane for lane, f in enumerate(flags) if f)


def vote(scores: np.ndarray) -> bool:
    """The block's vote: every thread j < K tests s[j] >= −1 and, unless it
    is the last, s[j] >= s[j+1]; both are false for NaN."""
    ok = scores >= F(-1.0)
    ok[:-1] &= scores[:-1] >= scores[1:]
    return bool(ok.all())


class _Tile:
    """One image as the kernel holds it after the load."""

    def __init__(self, boxes_t, scores, classes):
        cx, cy, w, h = (boxes_t[i].astype(F) for i in range(4))
        hw, hh = w * F(0.5), h * F(0.5)
        self.x1, self.x2 = cx - hw, cx + hw
        self.y1, self.y2 = cy - hh, cy + hh
        self.area = (self.x2 - self.x1) * (self.y2 - self.y1)
        self.score = scores.astype(F).copy()
        self.cls = classes
        self.k = len(scores)

    def intersection(self, p, j):
        ix = np.maximum(F(0), np.minimum(self.x2[p], self.x2[j])
                        - np.maximum(self.x1[p], self.x1[j]))
        iy = np.maximum(F(0), np.minimum(self.y2[p], self.y2[j])
                        - np.maximum(self.y1[p], self.y1[j]))
        return ix * iy

    def knocked_out(self, p, j, thr, aware):
        """Does candidate p knock j out (vectorised over j)? The division
        is skipped where the reference's IoU is 0 anyway."""
        j = np.asarray(j)
        inter = self.intersection(p, j)
        iou = np.zeros(j.shape, F)
        div = inter != F(0)
        if aware:
            div &= self.cls[p] == self.cls[j]
        uni = (self.area[p] + self.area[j]) - inter
        iou[div] = inter[div] / np.maximum(uni[div], F(1e-9))
        return iou > F(thr)

    def tests(self, others, j, thr, aware):
        """Threads j (an array) against the candidates ``others``: a bool
        [len(others), len(j)], true where the candidate knocks the thread
        out. Two passes, as in the kernel: "do the boxes intersect", then
        the full test where they do; where they do not, the IoU is 0, which
        exceeds a negative threshold only."""
        out = np.zeros((len(others), len(j)), bool)
        for row, p in zip(out, others):
            touch = self.intersection(p, j) != F(0)
            row[~touch] = F(0) > F(thr)
            row[touch] = self.knocked_out(p, j[touch], thr, aware)
        return out


def _sweep(t: _Tile, max_det, thr, aware):
    nwarps = (t.k + 31) // 32
    threads = nwarps * 32
    alive = np.zeros(threads, bool)             # one register per thread
    alive[:t.k] = t.score > F(-1.0)
    rows = [_ballot(alive[w * 32:(w + 1) * 32]) for w in range(nwarps)]
    members = [bin(r).count("1") for r in rows]  # alive ones are a prefix
    assert all(r == (1 << c) - 1 for r, c in zip(rows, members))
    # every alive thread against its own chunk, before the first step:
    # mine[j] bit m = member m of j's chunk knocks j out
    mine = np.zeros(threads, np.int64)
    for w in range(nwarps):
        j = np.arange(w * 32, w * 32 + members[w])
        bits = t.tests(j, j, thr, aware)        # [member, thread]
        mine[j] = (bits * (1 << np.arange(members[w]))[:, None]).sum(0)
    picks = []
    for step in range(nwarps):
        if rows[step] == 0:
            break                               # early exit
        before = len(picks)
        # the chunk's own warp settles it with ballots
        lanes = range(step * 32, step * 32 + 32)
        left = _ballot(alive[j] for j in lanes)
        while left and len(picks) < max_det:
            m = _ffs(left) - 1
            picks.append(step * 32 + m)
            out = _ballot((int(mine[j]) >> m) & 1 for j in lanes)
            left &= ~(out | (1 << m))
        # the barrier; then later alive candidates meet this chunk's picks
        if len(picks) >= max_det:
            break
        j = np.nonzero(alive)[0]
        j = j[j >= (step + 1) * 32]
        alive[j] = ~t.tests(picks[before:], j, thr, aware).any(0)
    n = len(picks)
    idx = np.array(picks + [0] * (max_det - n), np.int32)
    conf = np.concatenate([t.score[picks].astype(F),
                           np.full(max_det - n, -1.0, F)])
    return idx, conf, t.cls[idx]


def _explicit_rounds(t: _Tile, max_det, thr, aware):
    idx, conf = [], []
    j = np.arange(t.k)
    for _ in range(max_det):
        p = int(np.argmax(t.score))             # score desc, index asc
        idx.append(p)
        conf.append(t.score[p])
        out = t.knocked_out(p, j, thr, aware) | (j == p)
        t.score[out] = F(-1.0)
    idx = np.array(idx, np.int32)
    return idx, np.array(conf, F), t.cls[idx]


def kernel_model(boxes_t, scores, classes, *, iou_threshold, max_det,
                 class_aware):
    """[B,4,K], [B,K], [B,K] numpy → (idx, conf, cls) as the kernel writes
    them, and the path each block took."""
    outs, paths = [], []
    for b in range(scores.shape[0]):
        t = _Tile(boxes_t[b], scores[b], classes[b])
        fast = vote(t.score)
        run = _sweep if fast else _explicit_rounds
        outs.append(run(t, max_det, iou_threshold, class_aware))
        paths.append("sweep" if fast else "general")
    return tuple(np.stack(x) for x in zip(*outs)), paths


def _assert_model_equals_plain(boxes_t, masked, cls, *, max_det, aware,
                               thr=0.45):
    kw = dict(iou_threshold=thr, max_det=max_det, class_aware=aware)
    got, paths = kernel_model(boxes_t, masked, cls, **kw)
    want = _suppress_plain(torch.from_numpy(boxes_t),
                           torch.from_numpy(masked), torch.from_numpy(cls),
                           **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())
    return got, paths


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_plain_on_the_parity_cases(name):
    boxes, scores, kw = _problem(name)
    boxes_t, masked, cls = _preselected(boxes, scores, kw)
    aware = kw["class_aware"] and kw["num_classes"] > 1
    _, paths = _assert_model_equals_plain(boxes_t, masked, cls,
                                          max_det=kw["max_det"], aware=aware)
    assert set(paths) == {"sweep"}


def _smoke_inputs(name, batch=2):
    _, kind, aware, _, k, d = SMOKE_CASES[name]
    rng = np.random.default_rng(sorted(SMOKE_CASES).index(name))
    return chip_smoke.nms_inputs(rng, kind, batch, k), aware, d


@pytest.mark.parametrize("name", list(SMOKE_CASES))
def test_model_matches_plain_on_the_smoke_cases(name):
    (boxes_t, masked, cls), aware, d = _smoke_inputs(name)
    (_, conf, _), paths = _assert_model_equals_plain(
        boxes_t, masked, cls, max_det=d, aware=aware)
    general = name in ("unsorted", "below-minus-one")
    assert set(paths) == ({"general"} if general else {"sweep"})
    if name == "tile-like":                     # ends early, tail filled
        picks = (conf > -1).sum(1)
        assert (picks >= 10).all() and (picks < d).all()
    if name == "k-below-slots":
        assert masked.shape[1] < d
    if name == "below-conf":
        assert (conf == -1).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_rows_from_batched_nms_pass_the_vote(name, monkeypatch):
    """Whatever ``batched_nms`` hands the kernel is in priority order, so
    the port's paths take the sweep."""
    seen = []
    real = nms_kernel.nms_suppress

    def spy(boxes_t, scores, classes, **kw):
        seen.append(scores.numpy().copy())
        return real(boxes_t, scores, classes, **kw)

    monkeypatch.setattr(nms_kernel, "nms_suppress", spy)
    boxes, scores, kw = _problem(name)
    batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                conf_threshold=0.3, iou_threshold=0.45, **kw)
    assert len(seen) == 1 and seen[0].dtype == np.float32
    assert all(vote(row) for row in seen[0])


@pytest.mark.parametrize("name,expected", [
    (n, n not in ("unsorted", "below-minus-one")) for n in SMOKE_CASES])
def test_vote_on_the_smoke_generators(name, expected):
    (_, masked, _), _, _ = _smoke_inputs(name, batch=4)
    assert [vote(row) for row in masked] == [expected] * 4


def test_vote_rejects_nan_and_any_descent_break():
    row = np.array([0.9, 0.5, 0.5, -1.0, -1.0], F)
    assert vote(row)
    for bad in ([0.9, np.nan, 0.5, -1, -1], [0.5, 0.9, 0.5, -1, -1],
                [0.9, 0.5, -1, -1, -1.5], [0.9, 0.5, -1, 0.4, -1]):
        assert not vote(np.array(bad, F))
    assert vote(np.array([0.7], F)) and not vote(np.array([-3.0], F))


@st.composite
def _problems(draw):
    k = draw(st.integers(1, 70))
    d = draw(st.integers(1, 40))
    grid = st.sampled_from([-1.0, 0.3, 0.4, 0.5, 0.75, 0.9])
    scores = np.array(draw(st.lists(grid, min_size=k, max_size=k)), F)
    if draw(st.booleans()):
        scores = np.sort(scores)[::-1].copy()
    elif draw(st.booleans()):
        scores[draw(st.integers(0, k - 1))] = F(-2.0)
    lattice = st.sampled_from([10.0, 14.0, 18.0, 40.0])
    size = st.sampled_from([8.0, 10.0, 16.0])
    boxes = np.array([[draw(lattice), draw(lattice), draw(size), draw(size)]
                      for _ in range(k)], F).T
    cls = np.array(draw(st.lists(st.integers(0, 2), min_size=k, max_size=k)),
                   np.int32)
    thr = draw(st.sampled_from([-0.5, 0.0, 0.3, 0.45, 1.0]))
    return boxes[None], scores[None], cls[None], d, draw(st.booleans()), thr


@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(_problems())
def test_model_matches_plain_property(problem):
    boxes_t, scores, cls, d, aware, thr = problem
    _, paths = _assert_model_equals_plain(boxes_t, scores, cls, max_det=d,
                                          aware=aware, thr=thr)
    assert paths == ["sweep" if vote(scores[0]) else "general"]
