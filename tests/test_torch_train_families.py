"""One train step of the other families against the JAX package's, on the
CPU in f32: YOLOv8n from the trained fixture (64 px, batch 2, nc 2) and a
seeded XUnet of base 8 (64 px, batch 2, mask targets), each in both BN
modes; then ``fit`` on XUnet with a mask-IoU ``eval_fn``.

The reference's gradients come from its own ``make_train_step`` given an
optax transformation that keeps the gradients as its state (as in
``tests/test_torch_train.py``). Tolerances: loss rtol 1e-5; every gradient
leaf within 1e-4 of that leaf's largest magnitude (f32 sums in another
order; YOLOv8n's ``batch`` mode through the BN statistics of 2×2 P5
maps too). XUnet in ``batch`` mode, where the reference's f32 reductions
lose up to 1.7 % of a leaf's largest gradient (fast variance over the 4×4
bottleneck), is held as YOLOv7-tiny is there: within 1e-4 of each leaf's
largest against the reference's own step in f64 (``jax.enable_x64``, its
f32 head aside), and against its f32 step within that step's own error
plus 1e-4. The running statistics after a ``batch`` step within 2e-5 of
each leaf's largest; params after the update within 1e-6, except elements
whose gradient is within twice its tolerance of zero or below 1e-4, which
Adam's first update may move by up to 2·lr (lr 1e-3).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aerial_image_recognition_tpu.models.registry import (
    REGISTRY as JREG, ModelBundle as JaxModelBundle,
    create_model as jax_create_model)
from aerial_image_recognition_tpu.models.xunet import XUnet as JaxXUnet
from aerial_image_recognition_tpu.pipeline import train as JT
from aerial_image_recognition_tpu_torch.models.registry import (
    REGISTRY, ModelBundle, create_model)
from aerial_image_recognition_tpu_torch.models.weights import (
    _flatten, grads_to_flax)
from aerial_image_recognition_tpu_torch.models.xunet import XUnet
from aerial_image_recognition_tpu_torch.pipeline import train as PT

torch.set_num_threads(2)
V8_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                          "yolov8n_fakeworld.npz")
SIZE = 64
LR = 1e-3
_GRAB = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flatten(tree)}


def _yolov8n():
    jb = jax_create_model("yolov8n", dtype=jnp.float32,
                          params_path=V8_FIXTURE)
    pb = create_model("yolov8n", dtype=torch.float32,
                      variables=_np(jb.params), device="cpu")
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, (2, SIZE, SIZE, 3), dtype=np.uint8)
    targets = np.full((2, 8, 5), -1.0, np.float32)
    targets[0, :3] = [(0, 30, 30, 9, 5), (1, 12, 50, 20, 10),
                      (0, 52, 20, 5, 9)]
    targets[1, :2] = [(1, 40, 40, 30, 24), (0, 8, 8, 6, 4)]
    return jb, pb, (images, targets)


def _xunet():
    jm = JaxXUnet(out_channels=1, base=8, dtype=jnp.float32)
    variables = _np(jm.init(jax.random.PRNGKey(5),
                            jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    jspec = dataclasses.replace(
        JREG["xunet_256"], input_size=SIZE,
        make_module=lambda dtype=jnp.float32: JaxXUnet(1, base=8,
                                                       dtype=dtype))
    jb = JaxModelBundle(spec=jspec, module=jm, params=variables)
    spec = dataclasses.replace(REGISTRY["xunet_256"], input_size=SIZE,
                               make_module=lambda: XUnet(1, base=8))
    pb = ModelBundle(spec=spec, module=XUnet(1, base=8),
                     device=torch.device("cpu"), variables=variables)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 255, (2, SIZE, SIZE, 3), dtype=np.uint8)
    masks = np.zeros((2, SIZE, SIZE, 1), np.float32)
    masks[0, 10:30, 12:40] = 1.0
    masks[1, 35:60, 5:25] = 1.0
    return jb, pb, (images, masks)


MODELS = {"yolov8n": _yolov8n, "xunet": _xunet}
_CACHE = {}


def _model(name):
    if name not in _CACHE:
        _CACHE[name] = MODELS[name]()
    return _CACHE[name]


@pytest.mark.parametrize("name,mode", [
    ("yolov8n", "frozen"), ("yolov8n", "batch"),
    ("xunet", "frozen"), ("xunet", "batch")])
def test_train_step_equals_jax(name, mode):
    jb, pb, batch = _model(name)
    step = JT.make_train_step(jb, _GRAB, bn_mode=mode)
    out, m = step(JT.init_train_state(jb, _GRAB), *batch)
    jgrads = _np(out["opt_state"])
    tx = PT.make_optimizer(lr=LR)
    pstep = PT.make_train_step(pb, tx, bn_mode=mode)
    s0 = PT.init_train_state(pb, tx)
    loss, _, grads, stats = pstep.loss_and_grads(s0, *batch)
    np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-5)
    want = _flat(jgrads)
    got = _flat(grads_to_flax(grads)["params"])
    assert got.keys() == want.keys()
    tol = {k: 1e-4 * np.abs(v).max() for k, v in want.items()}
    if (name, mode) == ("xunet", "batch"):
        with jax.enable_x64():
            jb64 = dataclasses.replace(
                jb, module=JaxXUnet(1, base=8, dtype=jnp.float64),
                params=jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.float64), jb.params))
            out64, _ = JT.make_train_step(jb64, _GRAB, bn_mode=mode)(
                JT.init_train_state(jb64, _GRAB), *batch)
            exact = _flat(_np(out64["opt_state"]))
        for k in exact:
            np.testing.assert_allclose(
                got[k], exact[k], rtol=0,
                atol=1e-4 * np.abs(exact[k]).max(), err_msg=k)
        tol = {k: np.abs(want[k] - exact[k]) + 1e-4 * np.abs(exact[k]).max()
               for k in want}
    for k in want:
        assert (np.abs(got[k] - want[k]) <= tol[k]).all(), k
    if mode == "batch":
        want_s = _flat(_np(out["batch_stats"]))
        got_s = _flat(PT.state_to_flax({"params": grads,
                                        "batch_stats": stats})["batch_stats"])
        assert got_s.keys() == want_s.keys()
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], rtol=0,
                                       atol=2e-5 * np.abs(want_s[k]).max(),
                                       err_msg=k)
    # the update: the reference's optimizer on its own gradients
    jtx = JT.make_optimizer(lr=LR)
    upd, _ = jtx.update(jgrads, jtx.init(jb.params["params"]),
                        jb.params["params"])
    want_p = _flat(_np(optax.apply_updates(jb.params["params"], upd)))
    new, _ = pstep(s0, *batch)
    got_p = _flat(PT.state_to_flax(new)["params"])
    for k in want_p:
        noise = (np.abs(want[k]) <= 2 * tol[k]) | (np.abs(want[k]) <= 1e-4)
        diff = np.abs(got_p[k] - want_p[k])
        assert (diff[~noise] <= 1e-6).all(), k
        assert (diff[noise] <= 2 * LR * (1 + 1e-3)).all(), k


def test_xunet_fit_with_a_mask_iou_eval_fn():
    """``fit(eval_fn=...)``: the callback gets the state in the reference's
    format (flax-format trees, as ``fit`` returns it) and returns the mask
    IoU as the fitness, which drives ``best``; the loss falls on a
    repeated batch."""
    _, pb, (images, masks) = _model("xunet")

    class Loader:
        def epoch(self, i):
            yield images, masks

    seen = []

    def mask_iou(bundle, state):
        variables = {"params": state["params"],
                     "batch_stats": state["batch_stats"]}
        module = dataclasses.replace(bundle, variables=variables) \
            .trainable().eval()
        with torch.no_grad():
            x = torch.from_numpy(images).permute(0, 3, 1, 2).float() / 255
            pred = module(x).numpy() > 0
        truth = masks > 0.5
        iou = float((pred & truth).sum() / max((pred | truth).sum(), 1))
        seen.append((state["step"], iou))
        return {"mask_iou": iou, "fitness": iou}

    out = PT.fit(pb, Loader(), epochs=3, lr=1e-3, eval_fn=mask_iou,
                 log_fn=lambda m: None)
    assert [st for st, _ in seen] == [1, 2, 3]
    best = max(range(3), key=lambda i: (seen[i][1], i))
    assert out["best"]["epoch"] == best
    assert out["best"]["fitness"] == seen[best][1]
    assert [r["mask_iou"] for r in out["history"]] == [i for _, i in seen]
    losses = [r["loss"] for r in out["history"]]
    assert losses[-1] < losses[0]
