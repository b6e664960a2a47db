"""The port's trainer (``pipeline/train.py``) against the JAX package's, on
YOLOv7-tiny from the trained fixture, f32, 64 px, batch 2, on the CPU.

The reference's gradients come from its own ``make_train_step``, given an
optax transformation that keeps the gradients as its state; its updates
from its own ``make_optimizer`` applied to them (what its step does next).

Tolerances, stated per check:

* loss rtol 1e-5.
* gradients, ``frozen`` BN: every leaf within 2e-5 of that leaf's largest
  magnitude.
* gradients, ``batch`` BN: held against the reference's own step run in
  f64 (``jax.enable_x64``, its model in f64, heads f32): every leaf within
  1e-4 of that leaf's largest magnitude; and against the reference's f32
  step, every element within the reference's own f32 error (|f32 − f64|)
  plus 1e-4 of the leaf's largest. On channels whose batch variance is
  near zero flax's fast variance E[x²] − E[x]² cancels, and XLA's f32
  reductions lose up to 8 % of a leaf's largest gradient at these 2×2 P5
  maps; the port's CPU reductions accumulate in f64.
* running statistics after a ``batch`` step within 2e-5 of each leaf's
  largest magnitude.
* params after the update: Adam's first update is lr·g/(|g| + 1e-8),
  about lr·sign(g), so an element whose gradient lies within twice the
  gradient tolerance of zero may flip sign and move by 2·lr, and one below
  1e-4 moves with its gradient's relative error; those are held within
  2·lr (1 + 1e-3), all others within 1e-6 (lr 1e-3), and fewer than 1 %
  of the elements may differ by more than 1e-6.
* a JAX state after 3 steps (warmup-cosine schedule, EMA, freeze 0,1,2)
  carried to the port, one more step each: params and EMA within 1e-6,
  adam moments within 1e-4 of each leaf's largest magnitude, counts equal.
* schedules: lr at every step rtol 1e-6; the optimizer on a toy tree
  (clip, mask, decay, bias correction) rtol 1e-6.
* remat against the plain step, recalibration, checkpoints, resume:
  equal (tolerance 0) within the port; recalibration against JAX within
  1e-4 of each leaf's largest magnitude.
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
    create_model as jax_create_model)
from aerial_image_recognition_tpu.pipeline import train as JT
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.models.weights import (
    _flatten, flax_leaf_path, grads_to_flax)
from aerial_image_recognition_tpu_torch.pipeline import train as PT
from aerial_image_recognition_tpu_torch.runtime.train_ckpt import (
    load_train_state, save_train_state)

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")
SIZE = 64
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flatten(tree)}


@pytest.fixture(scope="module")
def bundles():
    jb = jax_create_model("yolov7_itcvd", dtype=jnp.float32,
                          params_path=FIXTURE)
    pb = create_model("yolov7_itcvd", dtype=torch.float32,
                      variables=_np(jb.params), device="cpu")
    return jb, pb


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (2, SIZE, SIZE, 3), dtype=np.uint8)
    targets = np.full((2, 8, 5), -1.0, np.float32)
    targets[0, :2] = [(0, 32, 32, 12, 10), (0, 10, 50, 9, 6)]
    targets[1, :3] = [(0, 20, 40, 8, 8), (0, 50, 10, 20, 14),
                      (0, 52, 12, 11, 13)]
    return images, targets


# optax transformation whose state is the last gradient it saw
_GRAB = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))
_JAX_GRADS = {}


def _jax_grads(bundles, batch, mode, x64=False):
    """(loss, grads, new batch_stats) of the reference's own train step;
    x64: its model in f64 (the heads stay f32 there)."""
    key = (mode, x64)
    if key not in _JAX_GRADS:
        jb, _ = bundles
        if x64:
            with jax.enable_x64():
                jb = jax_create_model("yolov7_itcvd", dtype=jnp.float64,
                                      params_path=FIXTURE)
                jb = dataclasses.replace(jb, params=jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.float64), jb.params))
                step = JT.make_train_step(jb, _GRAB, bn_mode=mode)
                out, m = step(JT.init_train_state(jb, _GRAB), *batch)
        else:
            step = JT.make_train_step(jb, _GRAB, bn_mode=mode)
            out, m = step(JT.init_train_state(jb, _GRAB), *batch)
        _JAX_GRADS[key] = (float(m["loss"]), _np(out["opt_state"]),
                           _np(out["batch_stats"]))
    return _JAX_GRADS[key]


def _grad_tol(bundles, batch, mode):
    """Per-element absolute tolerance of the gradients against the
    reference's f32 step (module docstring)."""
    want = _flat(_jax_grads(bundles, batch, mode)[1])
    if mode == "frozen":
        return {k: 2e-5 * np.abs(v).max() for k, v in want.items()}
    exact = _flat(_jax_grads(bundles, batch, mode, x64=True)[1])
    return {k: np.abs(v - exact[k]) + 1e-4 * np.abs(exact[k]).max()
            for k, v in want.items()}


@pytest.mark.parametrize("mode", ["frozen", "batch"])
def test_train_step_gradients_equal_jax(bundles, batch, mode):
    jloss, jgrads, jstats = _jax_grads(bundles, batch, mode)
    _, pb = bundles
    tx = PT.make_optimizer(lr=LR)
    step = PT.make_train_step(pb, tx, bn_mode=mode)
    loss, metrics, grads, stats = step.loss_and_grads(
        PT.init_train_state(pb, tx), *batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    want = _flat(jgrads)
    got = _flat(grads_to_flax(grads)["params"])
    assert got.keys() == want.keys()
    tol = _grad_tol(bundles, batch, mode)
    for k in want:
        assert (np.abs(got[k] - want[k]) <= tol[k]).all(), k
    if mode == "batch":
        # the reference's step in f64: within 1e-4 of each leaf's largest
        exact = _flat(_jax_grads(bundles, batch, mode, x64=True)[1])
        for k in exact:
            np.testing.assert_allclose(
                got[k], exact[k], rtol=0,
                atol=1e-4 * np.abs(exact[k]).max(), err_msg=k)
        want_s = _flat(jstats)
        got_s = _flat(PT.state_to_flax({"params": grads,
                                        "batch_stats": stats})["batch_stats"])
        assert got_s.keys() == want_s.keys()
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], rtol=0,
                                       atol=2e-5 * np.abs(want_s[k]).max(),
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["frozen", "batch"])
def test_params_after_the_update_equal_jax(bundles, batch, mode):
    jb, pb = bundles
    _, jgrads, _ = _jax_grads(bundles, batch, mode)
    jtx = JT.make_optimizer(lr=LR)
    upd, _ = jtx.update(jgrads, jtx.init(jb.params["params"]),
                        jb.params["params"])
    want = _flat(_np(optax.apply_updates(jb.params["params"], upd)))
    tx = PT.make_optimizer(lr=LR)
    new, metrics = PT.make_train_step(pb, tx, bn_mode=mode)(
        PT.init_train_state(pb, tx), *batch)
    assert new["step"] == 1 and new["opt_state"]["count"] == 1
    got = _flat(PT.state_to_flax(new)["params"])
    g = _flat(jgrads)
    tol = _grad_tol(bundles, batch, mode)
    flipped = 0
    for k in want:
        noise = (np.abs(g[k]) <= 2 * tol[k]) | (np.abs(g[k]) <= 1e-4)
        diff = np.abs(got[k] - want[k])
        assert (diff[~noise] <= 1e-6).all(), k
        assert (diff[noise] <= 2 * LR * (1 + 1e-3)).all(), k
        flipped += int((diff > 1e-6).sum())
    assert flipped < 0.01 * sum(v.size for v in want.values())


def _adam_state(opt_state):
    """(count, mu, nu) of a reference optimizer state as numpy trees over
    the trainable leaves (``MaskedNode``s of frozen leaves dropped)."""
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]

    def keep(tree):
        if isinstance(tree, dict):
            out = {k: keep(v) for k, v in tree.items()}
            return {k: v for k, v in out.items() if v is not None}
        if isinstance(tree, optax.MaskedNode):
            return None
        return np.asarray(tree)
    return int(adam.count), keep(adam.mu), keep(adam.nu)


def test_carried_jax_state_takes_the_same_step(bundles, batch):
    """A reference state after 3 steps (warmup 2 into cosine decay over 10,
    EMA 0.99, freeze 0,1,2 through multi_transform), carried across as
    numpy; both packages take one more step."""
    jb, pb = bundles
    prefixes = JT.resolve_freeze_prefixes(jb, [0, 1, 2])
    assert prefixes == PT.resolve_freeze_prefixes(pb, [0, 1, 2])
    kw = dict(lr=LR, schedule="cosine", total_steps=10, warmup_steps=2)
    jtx = JT.make_optimizer(
        **kw, param_mask=JT._freeze_mask(jb.params["params"], prefixes))
    jstep = JT.make_train_step(jb, jtx, ema_decay=0.99, freeze=prefixes)
    js = JT.init_train_state(jb, jtx, ema_decay=0.99)
    for _ in range(3):
        js, _ = jstep(js, *batch)
    count, mu, nu = _adam_state(js["opt_state"])
    carried = {"params": _np(js["params"]),
               "batch_stats": _np(js["batch_stats"]),
               "opt_state": {"count": count, "mu": mu, "nu": nu},
               "step": int(js["step"]),
               "ema_params": _np(js["ema_params"])}
    ps = PT.state_from_flax(carried, "cpu")
    js, jm = jstep(js, *batch)
    ptx = PT.make_optimizer(
        **kw, param_mask=PT._freeze_mask(pb.variables["params"], prefixes))
    pstep = PT.make_train_step(pb, ptx, ema_decay=0.99, freeze=prefixes)
    ps, pm = pstep(ps, *batch)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    got = PT.state_to_flax(ps)
    assert got["step"] == int(js["step"]) == 4
    jcount, jmu, jnu = _adam_state(js["opt_state"])
    assert got["opt_state"]["count"] == jcount == 4
    for name, g, w, atol in (
            ("params", got["params"], _np(js["params"]), None),
            ("ema", got["ema_params"], _np(js["ema_params"]), None),
            ("mu", got["opt_state"]["mu"], jmu, 1e-4),
            ("nu", got["opt_state"]["nu"], jnu, 1e-4)):
        g, w = _flat(g), _flat(w)
        assert g.keys() == w.keys(), name
        for k in w:
            tol = 1e-6 if atol is None else atol * np.abs(w[k]).max()
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol,
                                       err_msg=f"{name} {k}")
    # frozen leaves: bit-identical to the fixture's
    frozen = [k for k in _flat(got["params"])
              if k.split("/")[0] in ("stem0", "stem1")
              or k.startswith("elan1/cv1/")]
    fixture = _flat(pb.variables["params"])
    assert frozen
    for k in frozen:
        np.testing.assert_array_equal(_flat(got["params"])[k], fixture[k])


def _toy_updates(make, tx_kw, grads_seq, mask):
    """Updates of an optimizer from ``make`` on the toy tree over
    ``grads_seq``: the reference's through optax, the port's through
    ``AdamW.update``."""
    params = {"a": np.linspace(-1, 1, 5).astype(np.float32),
              "b": np.asarray([0.5, -2.0], np.float32)}
    if make is JT.make_optimizer:
        p = jax.tree_util.tree_map(jnp.asarray, params)
        tx = make(**tx_kw, param_mask=mask)
        s = tx.init(p)
        out = []
        for g in grads_seq:
            u, s = tx.update(jax.tree_util.tree_map(jnp.asarray, g), s, p)
            p = optax.apply_updates(p, u)
            out.append(_np(p))
        return out
    p = {k: torch.tensor(v) for k, v in params.items()}
    tx = make(**tx_kw, param_mask=mask)
    s = tx.init(p)
    out = []
    for g in grads_seq:
        p, s = tx.update(p, {k: torch.tensor(v) for k, v in g.items()}, s)
        out.append({k: v.numpy() for k, v in p.items()})
    return out


@pytest.mark.parametrize("tx_kw", [
    dict(lr=1e-2),
    dict(lr=1e-2, warmup_steps=3),
    dict(lr=1e-2, schedule="cosine", total_steps=8),
    dict(lr=1e-2, schedule="cosine", total_steps=8, warmup_steps=3),
    dict(lr=1e-2, schedule="linear", total_steps=8),
    dict(lr=1e-2, schedule="linear", total_steps=8, warmup_steps=3),
], ids=["constant", "constant-warmup", "cosine", "cosine-warmup", "linear",
        "linear-warmup"])
def test_schedules_and_optimizer_equal_optax(tx_kw):
    # lr at each step, against the optax schedules the reference's
    # make_optimizer builds from these arguments (pipeline/train.py:122-144)
    steps = 10
    lr, w = tx_kw["lr"], tx_kw.get("warmup_steps", 0)
    kind, total = tx_kw.get("schedule", "constant"), tx_kw.get("total_steps")
    if kind == "constant":
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, max(w, 1)),
             optax.constant_schedule(lr)], [w]) if w else (lambda n: lr)
    elif kind == "cosine":
        sched = optax.warmup_cosine_decay_schedule(
            0.0 if w else lr, lr, w, total, end_value=lr * 0.01)
    else:
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0 if w else lr, lr, max(w, 1)),
             optax.linear_schedule(lr, lr * 0.01, max(total - w, 1))], [w])
    ptx = PT.make_optimizer(**tx_kw)
    np.testing.assert_allclose([float(ptx.lr(n)) for n in range(steps)],
                               [float(sched(n)) for n in range(steps)],
                               rtol=1e-6, atol=0)
    if w:
        assert float(ptx.lr(0)) == 0.0       # the first update has lr 0
    # the whole optimizer on a toy tree: global-norm clip over the
    # trainable leaf only (|g| = 50 > 10 on the first steps), the frozen
    # leaf untouched, decoupled decay, bias correction over the count
    rng = np.random.default_rng(1)
    grads = [{"a": rng.normal(0, 20 if i < 2 else 0.1, 5).astype(np.float32),
              "b": rng.normal(0, 100, 2).astype(np.float32)}
             for i in range(steps)]
    for mask in (None, {"a": True, "b": False}):
        want = _toy_updates(JT.make_optimizer, tx_kw, grads, mask)
        got = _toy_updates(PT.make_optimizer, tx_kw, grads, mask)
        for w, g in zip(want, got):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                           atol=1e-7)
        if mask:
            np.testing.assert_array_equal(got[-1]["b"], [0.5, -2.0])


def test_freeze_mask_and_typo(bundles):
    jb, pb = bundles
    prefixes = ("stem0", "elan1/cv1", "detect2")
    want = JT._freeze_mask(jb.params["params"], prefixes)
    got = PT._freeze_mask(pb.variables["params"], prefixes)
    # keyed by the trainer's names: the same mask by flax path
    by_path = {"/".join(flax_leaf_path(n)[1]): v for n, v in got.items()}
    assert by_path == {k: bool(v) for k, v in _flat(_np(want)).items()}
    assert not got["stem0.conv.weight"] and got["stem1.bn.bias"]
    # the optimizer trains exactly the trainer's leaves it marks trainable
    params = PT.init_train_state(pb, PT.make_optimizer())["params"]
    assert params.keys() == got.keys()
    names = PT.make_optimizer(param_mask=got).trainable_names(params)
    assert names == [n for n in params if got[n]]
    for mod in (JT, PT):
        with pytest.raises(ValueError, match="matched no parameters"):
            mod._freeze_mask(pb.variables["params"], ("stem0", "elan9"))


def test_restore_frozen_stats_equals_jax(bundles):
    jb, pb = bundles
    old = _np(jb.params["batch_stats"])
    new = jax.tree_util.tree_map(lambda a: a + 1.0, old)
    prefixes = ("stem1", "elan1/cv2")
    want = _flat(_np(JT._restore_frozen_stats(old, new, prefixes)))
    # the port's takes the trainer's flat torch-named statistics
    t_old = PT.state_from_flax({"batch_stats": old})["batch_stats"]
    t_new = PT.state_from_flax({"batch_stats": new})["batch_stats"]
    mixed = PT._restore_frozen_stats(t_old, t_new, prefixes)
    got = _flat(PT.state_to_flax({"batch_stats": mixed})["batch_stats"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert mixed["stem1.bn.running_mean"] is t_old["stem1.bn.running_mean"]
    assert mixed["stem0.bn.running_var"] is t_new["stem0.bn.running_var"]


def test_remat_step_equals_plain_step(bundles, batch):
    """Activation checkpointing recomputes the forward in the backward; the
    running statistics of a batch step update once, and everything else
    is the plain step's (tolerance 0)."""
    _, pb = bundles
    tx = PT.make_optimizer(lr=LR)
    s0 = PT.init_train_state(pb, tx)
    plain, pm = PT.make_train_step(pb, tx, bn_mode="batch")(s0, *batch)
    remat, rm = PT.make_train_step(pb, tx, bn_mode="batch",
                                   remat=True)(s0, *batch)
    assert float(pm["loss"]) == float(rm["loss"])
    for part in ("params", "batch_stats"):
        for k in plain[part]:
            assert torch.equal(plain[part][k], remat[part][k]), (part, k)
    k = "elan2.cv3.bn.running_var"
    assert not torch.equal(plain["batch_stats"][k], s0["batch_stats"][k])


def test_recalibrate_bn_equals_jax(bundles, batch):
    jb, pb = bundles
    images, targets = batch

    class Loader:
        def epoch(self, i):
            rng = np.random.default_rng(i)
            for _ in range(2):
                yield (rng.integers(0, 255, images.shape, dtype=np.uint8),
                       targets)

    prefixes = ("stem0", "elan1")
    want = JT.recalibrate_bn(jb, dict(jb.params), Loader(), passes=2,
                             freeze_prefixes=prefixes)
    got = PT.recalibrate_bn(pb, PT.state_from_flax(pb.variables), Loader(),
                            passes=2, freeze_prefixes=prefixes)
    w = _flat(_np(want["batch_stats"]))
    g = _flat(PT.state_to_flax(got)["batch_stats"])
    assert g.keys() == w.keys()
    fixture = _flat(pb.variables["batch_stats"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0,
                                   atol=1e-4 * np.abs(w[k]).max(), err_msg=k)
        if k.startswith(("stem0/", "elan1/")):
            np.testing.assert_array_equal(g[k], fixture[k])
    assert not np.array_equal(g["elan2/out/bn/mean"],
                              fixture["elan2/out/bn/mean"])
    # a trainer state with EMA weights recalibrates with them: the same
    # statistics come back though its params are zeroed
    tx = PT.make_optimizer()
    s = PT.init_train_state(pb, tx, ema_decay=0.5)
    s["params"] = {k: v * 0 for k, v in s["params"].items()}
    t = PT.recalibrate_bn(pb, s, Loader(), passes=2, freeze_prefixes=prefixes)
    t = _flat(PT.state_to_flax(t)["batch_stats"])
    for k in w:
        np.testing.assert_array_equal(t[k], g[k])


def test_ema_tracks_the_reference_ramp(bundles, batch):
    _, pb = bundles
    tx = PT.make_optimizer(lr=LR)
    s0 = PT.init_train_state(pb, tx, ema_decay=0.9)
    s1, _ = PT.make_train_step(pb, tx, ema_decay=0.9)(s0, *batch)
    d = np.float32(0.9) * (1 - np.exp(np.float32(-1) / np.float32(2000)))
    k = "elan2.cv3.conv.weight"
    want = s0["ema_params"][k] * float(d) + s1["params"][k] * float(1 - d)
    assert torch.equal(s1["ema_params"][k], want)
    assert not torch.equal(s1["ema_params"][k], s1["params"][k])


def test_checkpoint_round_trip_and_resume(bundles, batch, tmp_path):
    _, pb = bundles
    tx = PT.make_optimizer(lr=LR, warmup_steps=2)
    step = PT.make_train_step(pb, tx, ema_decay=0.9)
    s = PT.init_train_state(pb, tx, ema_decay=0.9)
    s, _ = step(s, *batch)
    save_train_state(s, str(tmp_path / "epoch_0"))
    r = load_train_state(str(tmp_path / "epoch_0"),
                         PT.init_train_state(pb, tx, ema_decay=0.9))
    assert r["step"] == 1 and r["opt_state"]["count"] == 1
    for part in ("params", "batch_stats", "ema_params"):
        for k in s[part]:
            assert torch.equal(r[part][k], s[part][k]), (part, k)
    for part in ("mu", "nu"):
        for k in s["opt_state"][part]:
            assert torch.equal(r["opt_state"][part][k],
                               s["opt_state"][part][k])
    a, _ = step(s, *batch)
    b, _ = step(r, *batch)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
    # without EMA in the checkpoint, a template that wants it is refused
    save_train_state({k: v for k, v in s.items() if k != "ema_params"},
                     str(tmp_path / "plain"))
    with pytest.raises(KeyError, match="ema_params"):
        load_train_state(str(tmp_path / "plain"), r)

    class OneBatch:
        def epoch(self, i):
            yield batch

    logs = []
    ck = str(tmp_path / "ck")
    PT.fit(pb, OneBatch(), epochs=2, lr=LR, ckpt_dir=ck, log_fn=logs.append)
    assert sorted(os.listdir(ck)) == ["epoch_0", "epoch_1"]
    resumed = PT.fit(pb, OneBatch(), epochs=3, lr=LR, ckpt_dir=ck,
                     log_fn=logs.append)
    assert any("resumed from epoch 1 (step 2)" in m for m in logs)
    assert resumed["step"] == 3 and len(resumed["history"]) == 1
    straight = PT.fit(pb, OneBatch(), epochs=3, lr=LR, log_fn=logs.append)
    assert straight["history"][-1] == resumed["history"][-1]
    w, g = _flat(straight["params"]), _flat(resumed["params"])
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
