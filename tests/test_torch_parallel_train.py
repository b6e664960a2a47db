"""The port's data-parallel train step (``make_train_step(mesh=)``,
``fit(mesh=)``) against the port's single-device step on the global batch
and against the JAX package's mesh step, on the CPU in f32.

Models: YOLOv7-tiny from the trained fixture (frozen BN), yolov8n from its
trained fixture at 64 px (``batch`` BN, the family's default) and a seeded
XUnet of base 8 (frozen and ``batch`` BN); a global batch of 4 over meshes
of 2 and 4 CPU shards (the JAX side on as many of its virtual devices).
The shards' rows differ in brightness, so statistics taken per shard are
far from the global batch's.

Tolerances (those of tests/test_torch_train*.py): loss rtol 1e-4;
``frozen`` BN: every gradient leaf within 1e-4 of that leaf's largest
magnitude (f32 sums over shards in another order); ``batch`` BN: held
against the reference's own step in f64 on the global batch
(``jax.enable_x64``, its f32 heads aside), each leaf no further from it
than the f32 single-device steps are (the port's and the reference's, and
the reference's mesh step where it is compared), plus 1e-4 of the leaf's
largest magnitude: channels of near-zero batch variance amplify the f32
rounding of their inputs, in every package (the reference's f32 steps here
lose up to 0.6 % of a leaf's largest gradient); running statistics within
2e-5 of each leaf's largest; params after a step within 1e-6, except
elements whose gradient is within twice its tolerance of zero or below
1e-4, which Adam's first update may move by up to 2·lr (lr 1e-3), and fewer
than 1 % of the elements beyond 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model)
from aerial_image_recognition_tpu.models.xunet import XUnet as JaxXUnet
from aerial_image_recognition_tpu.pipeline import train as JT
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.models.weights import (
    grads_to_flax, state_to_flax)
from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
from aerial_image_recognition_tpu_torch.pipeline import train as PT
from test_torch_train import FIXTURE
from test_torch_train_families import (
    LR, SIZE, V8_FIXTURE, _GRAB, _flat, _np, _xunet)

torch.set_num_threads(2)
B = 4


def _images(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (B, SIZE, SIZE, 3), dtype=np.uint8)
    images[B // 2:] //= 4            # the later shards are much darker
    return images


def _det_targets():
    t = np.full((B, 8, 5), -1.0, np.float32)
    t[0, :2] = [(0, 32, 32, 12, 10), (0, 10, 50, 9, 6)]
    t[1, :1] = [(0, 20, 40, 8, 8)]
    t[2, :2] = [(0, 50, 10, 20, 14), (0, 52, 12, 11, 13)]
    t[3, :1] = [(0, 30, 30, 9, 5)]
    return t


def _v7():
    jb = jax_create_model("yolov7_itcvd", dtype=jnp.float32,
                          params_path=FIXTURE)
    pb = create_model("yolov7_itcvd", dtype=torch.float32,
                      variables=_np(jb.params), device="cpu")
    return jb, pb, (_images(0), _det_targets())


def _v8():
    jb = jax_create_model("yolov8n", dtype=jnp.float32,
                          params_path=V8_FIXTURE)
    pb = create_model("yolov8n", dtype=torch.float32,
                      variables=_np(jb.params), device="cpu")
    t = _det_targets()
    t[1, 0, 0] = t[3, 0, 0] = 1                 # the second class
    return jb, pb, (_images(1), t)


def _unet():
    jb, pb, _ = _xunet()
    masks = np.zeros((B, SIZE, SIZE, 1), np.float32)
    for k in range(B):
        masks[k, 8 + 6 * k:30 + 6 * k, 10:40 - 4 * k] = 1.0
    return jb, pb, (_images(2), masks)


MODELS = {"yolov7": _v7, "yolov8n": _v8, "xunet": _unet}
_CACHE = {}


def _model(name):
    if name not in _CACHE:
        _CACHE[name] = MODELS[name]()
    return _CACHE[name]


def _cpu(n):
    return Mesh([torch.device("cpu")] * n)


def _jax_mesh(n):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


_EXACT = {}


def _exact(name):
    """(the reference's f64 gradients, its f32 gradients) of one
    single-device ``batch``-mode step on the global batch, flax-flat."""
    if name not in _EXACT:
        jb, _, batch = _model(name)
        out32, _ = JT.make_train_step(jb, _GRAB, bn_mode="batch")(
            JT.init_train_state(jb, _GRAB), *batch)
        with jax.enable_x64():
            if name == "xunet":
                module = JaxXUnet(1, base=8, dtype=jnp.float64)
            else:
                module = jax_create_model(name, dtype=jnp.float64).module
            jb64 = dataclasses.replace(
                jb, module=module, params=jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.float64), jb.params))
            out64, _ = JT.make_train_step(jb64, _GRAB, bn_mode="batch")(
                JT.init_train_state(jb64, _GRAB), *batch)
            exact = _flat(_np(out64["opt_state"]))
        _EXACT[name] = (exact, _flat(_np(out32["opt_state"])))
    return _EXACT[name]


def _leaf_err(got, exact):
    # a leaf whose exact gradient is 0 (a branch the loss does not reach)
    # is measured in absolute terms
    return {k: np.abs(got[k] - exact[k]).max()
            / max(np.abs(exact[k]).max(), 1e-12) for k in exact}


def _as_exact_as(name, grads, *others):
    """The ``batch``-mode bar of the module docstring: each leaf of
    ``grads`` (trainer-named tensors) no further from the f64 step than
    the f32 steps ``others`` (flax-flat) and the reference's own f32 step
    are, plus 1e-4."""
    exact, f32 = _exact(name)
    got = _leaf_err(_flat(grads_to_flax(grads)["params"]), exact)
    refs = [_leaf_err(o, exact) for o in others + (f32,)]
    for k in exact:
        assert got[k] <= max(r[k] for r in refs) + 1e-4, (k, got[k])


CASES = [("yolov7", "frozen", 2), ("yolov7", "frozen", 4),
         ("yolov8n", "batch", 2), ("yolov8n", "batch", 4),
         ("xunet", "frozen", 4), ("xunet", "batch", 2)]


@pytest.mark.parametrize("name,mode,n", CASES)
def test_dp_grads_equal_single_device_on_the_global_batch(name, mode, n):
    _, pb, batch = _model(name)
    tx = PT.make_optimizer(lr=LR)
    s0 = PT.init_train_state(pb, tx)
    loss1, _, g1, bs1 = PT.make_train_step(pb, tx, bn_mode=mode) \
        .loss_and_grads(s0, *batch)
    loss2, _, g2, bs2 = PT.make_train_step(pb, tx, bn_mode=mode,
                                           mesh=_cpu(n)) \
        .loss_and_grads(s0, *batch)
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-4)
    assert g2.keys() == g1.keys()
    if mode == "batch":
        _as_exact_as(name, g2, _flat(grads_to_flax(g1)["params"]))
    else:
        for k in g1:
            assert _rel(g2[k], g1[k]) <= 1e-4, k
    for k in bs1:
        assert _rel(bs2[k], bs1[k]) <= 2e-5, k
    if mode == "batch":
        # the statistics really are the global batch's: the same step with
        # each shard's own statistics misses both bars
        step = PT.make_train_step(pb, tx, bn_mode=mode, mesh=_cpu(n))
        real = PT._set_bn_sync
        try:
            PT._set_bn_sync = lambda m, sync: real(m, None)
            loss3, _, g3, bs3 = step.loss_and_grads(s0, *batch)
        finally:
            PT._set_bn_sync = real
        assert max(_rel(bs3[k], bs1[k]) for k in bs1) > 100 * 2e-5
        assert max(_rel(g3[k], g1[k]) for k in g1) > 100 * 1e-4


@pytest.mark.parametrize("name,mode,n", [("yolov7", "frozen", 4),
                                         ("yolov8n", "batch", 2),
                                         ("xunet", "frozen", 2),
                                         ("xunet", "batch", 4)])
def test_dp_grads_equal_jax_mesh_step(name, mode, n):
    jb, pb, batch = _model(name)
    jstep = JT.make_train_step(jb, _GRAB, mesh=_jax_mesh(n), bn_mode=mode)
    out, m = jstep(JT.init_train_state(jb, _GRAB), *batch)
    want = _flat(_np(out["opt_state"]))
    tx = PT.make_optimizer(lr=LR)
    loss, _, grads, stats = PT.make_train_step(
        pb, tx, bn_mode=mode, mesh=_cpu(n)).loss_and_grads(
            PT.init_train_state(pb, tx), *batch)
    np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-4)
    got = _flat(grads_to_flax(grads)["params"])
    assert got.keys() == want.keys()
    if mode == "batch":
        _as_exact_as(name, grads, want)
    else:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-4 * np.abs(want[k]).max(),
                                       err_msg=k)
    if mode == "batch":
        jstats = _flat(_np(out["batch_stats"]))
        pstats = _flat(state_to_flax({"batch_stats": stats})["batch_stats"])
        for k in jstats:
            np.testing.assert_allclose(
                pstats[k], jstats[k], rtol=0,
                atol=2e-5 * np.abs(jstats[k]).max(), err_msg=k)


def _params_close(got, want, grads, gtol):
    """The 2·lr rule of the module docstring over one step's params."""
    far = total = 0
    for k in want:
        d = (got[k] - want[k]).abs()
        g = grads[k].abs()
        flip = (g <= 2 * gtol[k]) | (g < 1e-4)
        assert (d[flip] <= 2 * LR * (1 + 1e-3)).all(), k
        assert (d[~flip] <= 1e-6).all(), k
        far += int((d > 1e-6).sum())
        total += d.numel()
    assert far < 0.01 * total


@pytest.mark.parametrize("name,mode", [("yolov7", "frozen"),
                                       ("yolov8n", "batch")])
def test_dp_step_updates_as_single_device(name, mode):
    """The whole step (clip, AdamW, EMA, freeze of layers 0–2) over 4
    shards against the single-device step on the global batch: params and
    EMA by the 2·lr rule, statistics within 2e-5, frozen leaves untouched
    and identical."""
    _, pb, batch = _model(name)
    kw = dict(bn_mode=mode, ema_decay=0.9, freeze=[0, 1, 2])
    mask = PT._freeze_mask(pb.variables["params"],
                           PT.resolve_freeze_prefixes(pb, [0, 1, 2]))
    tx = PT.make_optimizer(lr=LR, param_mask=mask)
    s0 = PT.init_train_state(pb, tx, ema_decay=0.9)
    one = PT.make_train_step(pb, tx, **kw)
    _, _, grads, _ = one.loss_and_grads(s0, *batch)
    s1, m1 = one(s0, *batch)
    s4, m4 = PT.make_train_step(pb, tx, mesh=_cpu(4), **kw)(s0, *batch)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-4)
    gtol = {k: 1e-4 * float(g.abs().max()) for k, g in grads.items()}
    trained = list(s1["opt_state"]["mu"])
    _params_close({k: s4["params"][k] for k in trained},
                  {k: s1["params"][k] for k in trained}, grads, gtol)
    _params_close({k: s4["ema_params"][k] for k in trained},
                  {k: s1["ema_params"][k] for k in trained}, grads, gtol)
    for k, keep in mask.items():
        if not keep:
            assert torch.equal(s4["params"][k], s0["params"][k]), k
    for k in s1["batch_stats"]:
        assert _rel(s4["batch_stats"][k], s1["batch_stats"][k]) <= 2e-5, k
    assert s4["step"] == s1["step"] == 1


def test_fit_with_a_mesh_equals_fit():
    """``fit(mesh=)`` on XUnet, two epochs of two batches, against ``fit``:
    the loss history within rtol 1e-4, the final params within 2·lr a
    step."""
    _, pb, (images, masks) = _model("xunet")

    class Loader:
        cfg = None

        def epoch(self, e):
            for k in (0, 2):
                sl = slice(k, k + 2)
                yield np.concatenate([images[sl], images[sl]]), \
                    np.concatenate([masks[sl], masks[sl]])

    kw = dict(epochs=2, lr=LR, bn_mode="frozen", log_fn=lambda *_: None)
    one = PT.fit(pb, Loader(), **kw)
    two = PT.fit(pb, Loader(), mesh=_cpu(2), **kw)
    np.testing.assert_allclose([r["loss"] for r in two["history"]],
                               [r["loss"] for r in one["history"]],
                               rtol=1e-4)
    a, b = _flat(two["params"]), _flat(one["params"])
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=4 * 2 * LR,
                                   err_msg=k)


@pytest.mark.parametrize("name,mode", [("yolov7", "frozen"),
                                       ("yolov8n", "batch")])
def test_remat_under_a_mesh(name, mode):
    """remat over a mesh (every shard's forward checkpointed at once and
    recomputed in lockstep, a synchronized BatchNorm included) equals the
    step without it (tolerance 0), statistics included."""
    _, pb, batch = _model(name)
    tx = PT.make_optimizer(lr=LR)
    s0 = PT.init_train_state(pb, tx)
    plain = PT.make_train_step(pb, tx, mesh=_cpu(2), bn_mode=mode) \
        .loss_and_grads(s0, *batch)
    remat = PT.make_train_step(pb, tx, mesh=_cpu(2), bn_mode=mode,
                               remat=True).loss_and_grads(s0, *batch)
    assert torch.equal(plain[0], remat[0])
    for k in plain[2]:
        assert torch.equal(plain[2][k], remat[2][k]), k
    for k in plain[3]:
        assert torch.equal(plain[3][k], remat[3][k]), k


def test_mesh_must_start_on_the_bundles_device():
    _, pb, _ = _model("yolov7")
    with pytest.raises(ValueError, match="first device"):
        PT.make_train_step(pb, PT.make_optimizer(),
                           mesh=Mesh([torch.device("meta")]))
    with pytest.raises(ValueError, match="mesh"):
        tx = PT.make_optimizer()
        PT.make_train_step(pb, tx, mesh=_cpu(3)).loss_and_grads(
            PT.init_train_state(pb, tx), *_model("yolov7")[2])
