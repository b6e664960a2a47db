"""``correct`` comes out false when the timed path is broken underneath:
each cell run end to end on the CPU at a tiny size (``tiny.run_cell``),
with one fault planted in the program's step, and once sound.

The faults an inference cell can have: half of the batch left out (its
rows' detections dropped), an answer altered where it is produced (one
tile's detections moved 100 m), and on the four-card mesh the exchange
between cards left out (only the first shard's rows gathered). A step
that returns its state unchanged has no counterpart here: the step keeps
no state.
"""

import pytest
import torch

import tiny


def _half_batch(out):
    det, lon, lat = out
    valid = det.valid.clone()
    valid[valid.shape[0] // 2:] = False
    return det._replace(valid=valid), lon, lat


def _altered(out):
    det, lon, lat = out
    boxes = det.boxes.clone()
    boxes[0, :, 0] += 200.0
    return det._replace(boxes=boxes), lon, lat


@pytest.fixture
def fault(monkeypatch):
    from aerial_image_recognition_tpu_torch.pipeline import inference

    def plant(kind):
        if kind == "exchange":
            def first_shard_only(outs, device):
                det, lon, lat = outs[0]
                n = det.valid.shape[0]
                rest = [o[0]._replace(valid=torch.zeros_like(o[0].valid))
                        for o in outs[1:]]
                outs = [(det, lon, lat)] + [(r, o[1], o[2])
                                            for r, o in zip(rest, outs[1:])]
                assert n
                return gather(outs, device)
            gather = inference._gather
            monkeypatch.setattr(inference, "_gather", first_shard_only)
            return
        call = inference.DetectStep.__call__
        broken = {"half_batch": _half_batch, "altered": _altered}[kind]
        monkeypatch.setattr(inference.DetectStep, "__call__",
                            lambda self, im, bd: broken(call(self, im, bd)))
    return plant


@pytest.mark.parametrize("cell", ["v7tiny-ring-640", "v7tiny-scan-1280",
                                  "v7tiny-dp4-640"])
def test_sound_run_is_correct(cell):
    assert tiny.run_cell(cell, 21)["correct"]


@pytest.mark.parametrize("cell, kind", [
    ("v7tiny-ring-640", "half_batch"), ("v7tiny-ring-640", "altered"),
    ("v7tiny-scan-1280", "half_batch"), ("v7tiny-scan-1280", "altered"),
    ("v7tiny-dp4-640", "half_batch"), ("v7tiny-dp4-640", "altered"),
    ("v7tiny-dp4-640", "exchange")])
def test_fault_is_not_correct(cell, kind, fault):
    fault(kind)
    line = tiny.run_cell(cell, 22)
    assert line["correct"] is False, line["checks"]
