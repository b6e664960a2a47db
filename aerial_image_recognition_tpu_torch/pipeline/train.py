"""Training: the fine-tune and from-scratch trainer of the port.

Counterpart of ``aerial_image_recognition_tpu/pipeline/train.py`` (the
reference's in-framework replacement for the ultralytics notebook
workflow), with its names, signatures and defaults: ``TrainState``,
``resolve_freeze_prefixes``, ``_freeze_mask``, ``_restore_frozen_stats``,
``make_optimizer``, ``resolve_bn_mode``, ``make_train_step``,
``init_train_state``, ``recalibrate_bn``, ``fit`` and ``evaluate``.

What the reference gets from flax and optax is written out here, to the
same semantics:

* BatchNorm in the ``frozen`` and ``batch`` modes of flax
  (``models/layers.BatchNorm``: the old average weighted 0.97, the biased
  batch variance, statistics in f32). In ``batch`` mode the forward uses
  the batch's statistics in every layer, frozen ones included, and only
  the running statistics of frozen layers are put back afterwards.
* ``clip_by_global_norm(10)`` then ``adamw(b1=0.9, b2=0.999, eps=1e-8)``:
  the clip is optax's ``g / ‖g‖ · 10`` (no epsilon), the norm over the
  trainable leaves only; decay applies to every trainable leaf, BN scale
  and bias included; update n (from 0) uses ``schedule(n)``. Frozen leaves
  get no update and no decay: the same tensors come back.
* The schedules (``warmup_cosine_decay_schedule`` and the two
  ``join_schedules`` forms), as f32 functions of the update count.

The train state is a dict like the reference's. Its trees are flat dicts
of tensors on the model's device, keyed by the torch module's names
(``stem0.conv.weight``): ``init_train_state``, the step, ``recalibrate_bn``
and ``evaluate`` take and return that format. Flax-format numpy trees (the
reference's paths and layouts) appear only at the edges, through
``models/weights.state_from_flax`` and ``state_to_flax``: ``fit``'s result,
the state an ``eval_fn`` gets and the checkpoints
(``runtime/train_ckpt.py``). ``_freeze_mask`` reads the flax paths of
``bundle.variables["params"]``, as the reference's does, and keys its mask
by the trainer's names, as the optimizer's ``param_mask``.

The forward runs ``torch.func.functional_call`` over one unfused f32 copy of
the model per bundle (``ModelBundle.trainable``), on inputs rounded to bf16
by ``preprocess_batch`` exactly as the reference's. cuDNN's TF32 is off for
the trainer's convolutions (restored afterwards): the reference trains in
f32.

Data-parallel training (``mesh``, a ``parallel/mesh.Mesh``) computes what
the reference's ``jit`` over a mesh computes: the single-device step on the
global batch. Each local shard runs the forward on its rows on its device,
over its own copy of the module; the head outputs are gathered in shard
order (process-major across processes) and the loss is taken over the
global batch; ``batch``-mode BatchNorm takes its statistics, and its
running update, over the global batch (``_ShardSync``: in-process shards
run their forwards in lockstep threads and add their per-channel sums
through autograd; processes add them with a differentiable ``all_reduce``);
the gradients are summed over shards and processes, and one AdamW update
leaves identical parameters everywhere. Across processes the step uses
``all_reduce`` alone (gloo takes it for CUDA tensors too).
"""

import math
import os
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from aerial_image_recognition_tpu_torch.models.layers import (
    BN_MOMENTUM, BatchNorm, clear_batch_stats, set_bn_mode)
from aerial_image_recognition_tpu_torch.models.registry import ModelBundle
from aerial_image_recognition_tpu_torch.models.weights import (
    _flatten, flax_leaf_path, state_from_flax, state_to_flax,
    torch_leaf_name)
from aerial_image_recognition_tpu_torch.ops.losses import (
    xunet_loss, yolov7_loss, yolov8_loss)
from aerial_image_recognition_tpu_torch.ops.preprocess import (
    preprocess_batch)
from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
from aerial_image_recognition_tpu_torch.runtime.device import (
    canonical, on_device)

@dataclass
class TrainState:
    params: Any          # {'params': ..., 'batch_stats': ...}
    opt_state: Any
    step: int = 0


# ------------------------------------------------------------- freezing

def resolve_freeze_prefixes(bundle: ModelBundle, freeze) -> tuple:
    """Normalize a ``freeze`` spec into flax param-path prefixes.

    Accepts upstream yaml layer indices (the ultralytics ``freeze=[0,1,2]``
    addressing, through ``models/import_torch.layer_index_prefixes``)
    and/or explicit module-path prefixes ('stem0', 'elan1/cv1'). Indices
    absent from the table address parameterless layers and are no-ops.
    """
    if not freeze:
        return ()
    prefixes = []
    index_table = None
    for item in freeze:
        if isinstance(item, str) and not item.isdigit():
            prefixes.append(item)
            continue
        if index_table is None:
            from aerial_image_recognition_tpu_torch.models.import_torch import (
                layer_index_prefixes)
            index_table = layer_index_prefixes(bundle.spec.name)
        prefixes.extend(index_table.get(int(item), []))
    return tuple(prefixes)


def _frozen(parts, pref) -> bool:
    return any(parts[:len(p)] == p for p in pref)


def _freeze_mask(params, prefixes) -> Dict[str, bool]:
    """{trainer name: True = trainable} over the leaves of the flax-format
    ``params`` (e.g. ``bundle.variables["params"]``). A leaf is frozen when
    its flax path starts with any prefix. Raises when a prefix matches
    nothing: a typo must not silently train the layer the user believes is
    frozen."""
    pref = [p.split("/") for p in prefixes]
    hits = [0] * len(pref)
    flat = {}
    for path, _ in _flatten(params):
        frozen = False
        for i, p in enumerate(pref):
            if list(path[:len(p)]) == p:
                hits[i] += 1
                frozen = True
        flat[torch_leaf_name("params", path)[0]] = not frozen
    missing = [prefixes[i] for i, h in enumerate(hits) if h == 0]
    if missing:
        raise ValueError(
            f"freeze prefixes matched no parameters: {missing} — check "
            "them against the model's module paths (e.g. 'stem0', "
            "'elan1/cv1')")
    return flat


def _restore_frozen_stats(old_stats, new_stats, prefixes):
    """batch-mode BN in frozen layers must not update its running
    statistics either: their leaves come from ``old_stats`` (the trainer's
    flat torch-named statistics)."""
    pref = [p.split("/") for p in prefixes]
    return {name: old_stats[name]
            if _frozen(list(flax_leaf_path(name)[1]), pref)
            else new_stats[name] for name in new_stats}


# ------------------------------------------------------------ optimizer

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int, transition_begin: int = 0):
    """``optax.linear_schedule`` in f32."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        c = min(max(int(count) - transition_begin, 0), transition_steps)
        frac = np.float32(1) - np.float32(c) / np.float32(transition_steps)
        return np.float32(init_value - end_value) * frac \
            + np.float32(end_value)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """``optax.cosine_decay_schedule`` (exponent 1) in f32."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = np.float32(min(int(count), decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps)))
        decayed = np.float32(1 - alpha) * cosine + np.float32(alpha)
        return np.float32(init_value) * decayed
    return schedule


def join_schedules(schedules, boundaries):
    """``optax.join_schedules``: schedule i+1 from boundary i on, counted
    from that boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule`` (exponent 1) in f32."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha)], [warmup_steps])


class AdamW:
    """``optax.chain(clip_by_global_norm(10), adamw(schedule,
    weight_decay))`` (b1 0.9, b2 0.999, eps 1e-8), under
    ``multi_transform`` with ``set_to_zero`` for frozen leaves when a mask
    is given.

    ``schedule`` is a float (constant) or a function of the update count;
    ``param_mask`` is keyed like the params (``_freeze_mask``).
    ``init(params)`` → opt state ``{"count": 0, "mu": …, "nu": …}`` over the
    trainable names; ``update(params, grads, opt_state)`` → (new params,
    new opt state), out of place, frozen leaves passed through."""

    MAX_NORM, B1, B2, EPS = 10.0, 0.9, 0.999, 1e-8

    def __init__(self, schedule, weight_decay: float = 5e-4,
                 param_mask: Any = None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.param_mask = param_mask

    def lr(self, count: int) -> np.float32:
        """The learning rate of update ``count`` (from 0)."""
        s = self.schedule
        return np.float32(s(count) if callable(s) else s)

    def trainable_names(self, params: Mapping[str, torch.Tensor]):
        if self.param_mask is None:
            return list(params)
        return [n for n in params if self.param_mask[n]]

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        names = self.trainable_names(params)
        return {"count": 0,
                "mu": {n: torch.zeros_like(params[n]) for n in names},
                "nu": {n: torch.zeros_like(params[n]) for n in names}}

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], opt_state: Dict):
        names = list(opt_state["mu"])
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        # clip_by_global_norm over the trainable leaves
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        if not bool(norm < self.MAX_NORM):
            g = torch._foreach_div(g, norm)
            torch._foreach_mul_(g, self.MAX_NORM)
        # scale_by_adam
        b1, b2 = self.B1, self.B2
        mu = torch._foreach_add(
            torch._foreach_mul(g, 1 - b1),
            torch._foreach_mul([opt_state["mu"][n] for n in names], b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul([opt_state["nu"][n] for n in names], b2))
        count = opt_state["count"]
        n1 = np.float32(count + 1)
        dev = g[0].device
        bc1 = torch.tensor(np.float32(1) - np.float32(b1) ** n1, device=dev)
        bc2 = torch.tensor(np.float32(1) - np.float32(b2) ** n1, device=dev)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.EPS)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        # add_decayed_weights, then scale_by_learning_rate
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, float(-self.lr(count)))
        new_p = torch._foreach_add(p, u)
        out = dict(params)
        out.update(zip(names, new_p))
        return out, {"count": count + 1, "mu": dict(zip(names, mu)),
                     "nu": dict(zip(names, nu))}


def make_optimizer(lr: float = 1e-4, weight_decay: float = 5e-4,
                   total_steps: Optional[int] = None,
                   warmup_steps: int = 0, schedule: str = "constant",
                   final_lr_frac: float = 0.01,
                   param_mask: Any = None) -> AdamW:
    """lr0 = 1e-4 (the reference's training config). schedule: 'constant',
    'cosine' or 'linear' — a warmup ramp into a decay toward
    lr·final_lr_frac; both decays need total_steps. param_mask:
    ``_freeze_mask``'s {name: True = trainable}."""
    if schedule == "constant" and warmup_steps:
        lr = join_schedules(
            [linear_schedule(0.0, lr, max(warmup_steps, 1)),
             lambda count, v=lr: v], [warmup_steps])
    elif schedule != "constant":
        if not total_steps:
            raise ValueError(f"schedule={schedule!r} requires total_steps")
        end = lr * final_lr_frac
        if schedule == "cosine":
            sched = warmup_cosine_decay_schedule(
                init_value=0.0 if warmup_steps else lr, peak_value=lr,
                warmup_steps=warmup_steps, decay_steps=total_steps,
                end_value=end)
        elif schedule == "linear":
            sched = join_schedules(
                [linear_schedule(0.0 if warmup_steps else lr, lr,
                                 max(warmup_steps, 1)),
                 linear_schedule(lr, end,
                                 max(total_steps - warmup_steps, 1))],
                [warmup_steps])
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
        lr = sched
    return AdamW(lr, weight_decay=weight_decay, param_mask=param_mask)


def resolve_bn_mode(bundle: ModelBundle, bn_mode: str) -> str:
    """'auto' → the per-family default: 'batch' for yolov8 (its C2f
    residual stacks diverge with frozen statistics), 'frozen' for yolov7
    and xunet."""
    if bn_mode != "auto":
        return bn_mode
    return "batch" if bundle.spec.family == "yolov8" else "frozen"


# ---------------------------------------------------------------- state

def _train_module(bundle: ModelBundle) -> torch.nn.Module:
    """The bundle's unfused f32 training copy, built once: every forward
    supplies its own tensors through ``functional_call``."""
    module = bundle.__dict__.get("_train_module")
    if module is None:
        # eval(): a BN left in mode None must never update the running
        # statistics functional_call hands it in place
        module = bundle.trainable().requires_grad_(False).eval()
        bundle.__dict__["_train_module"] = module
    return module


def init_train_state(bundle: ModelBundle, tx: AdamW,
                     ema_decay: float = 0.0) -> Dict:
    """A fresh state from ``bundle.variables`` (copies: the bundle's own
    weights are never touched), on the bundle's device."""
    state = state_from_flax(
        {"params": bundle.variables["params"],
         "batch_stats": bundle.variables.get("batch_stats", {})},
        bundle.device)
    state["opt_state"] = tx.init(state["params"])
    state["step"] = 0
    if ema_decay > 0.0:
        state["ema_params"] = {n: t.clone()
                               for n, t in state["params"].items()}
    return state


# -------------------------------------------------------------- forward

@contextmanager
def _f32_convs():
    """cuDNN runs f32 convolutions in TF32 by default (operands rounded to
    10 mantissa bits); the trainer's are taken in f32, as the
    reference's."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _images_in(images, device) -> torch.Tensor:
    """uint8 [B,S,S,3] (numpy or tensor) → the f32 module's input: /255
    rounded to bf16 as the reference's ``preprocess_batch(..., dtype=
    bfloat16)``, then widened."""
    x = images if isinstance(images, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(images))
    x = x.to(device)
    return preprocess_batch(x, out_size=x.shape[1],
                            dtype=torch.bfloat16).float()


def _fold_batch_stats(module: torch.nn.Module,
                      batch_stats: Mapping[str, torch.Tensor]) -> Dict:
    """flax's running update from the statistics the last forward kept:
    ``ra = 0.97·ra + (1 − 0.97)·batch`` (biased variance)."""
    new = dict(batch_stats)
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm) and m.batch_mean is not None:
            for key, batch in (("running_mean", m.batch_mean),
                               ("running_var", m.batch_var)):
                full = f"{name}.{key}"
                new[full] = BN_MOMENTUM * batch_stats[full] \
                    + (1 - BN_MOMENTUM) * batch
    return new


def _apply(module, params, batch_stats, x):
    return functional_call(module, {**params, **batch_stats}, (x,))


class TrainStep:
    """``make_train_step``'s step: ``step(state, images_u8 [B,S,S,3],
    targets [B,T,5]) → (state, metrics)``. The state is not modified; the
    returned one shares the frozen leaves' tensors with it.
    ``loss_and_grads`` is the step up to the optimizer (the reference's
    ``value_and_grad`` of its ``loss_fn``), for the parity tests."""

    def __init__(self, bundle: ModelBundle, tx: AdamW, loss_kwargs=None,
                 bn_mode: str = "auto", remat: bool = False,
                 ema_decay: float = 0.0, freeze=None, mesh=None):
        self.bundle = bundle
        self.tx = tx
        self.loss_kwargs = loss_kwargs or {}
        self.bn_mode = resolve_bn_mode(bundle, bn_mode)
        self.remat = remat
        self.ema_decay = ema_decay
        self.freeze_prefixes = resolve_freeze_prefixes(bundle, freeze)
        self.module = _train_module(bundle)
        self.mesh = mesh = mesh or Mesh([bundle.device])
        if canonical(mesh.devices[0]) != canonical(bundle.device):
            raise ValueError(
                f"the mesh's first device {mesh.devices[0]} must hold "
                f"the train state (the bundle is on {bundle.device})")
        # shard 0 trains on the bundle's own module; each other shard on
        # its own copy (functional_call swaps a module's tensors, and a
        # BatchNorm keeps its batch statistics)
        self.shard_modules = [self.module] + [
            bundle.trainable(d).requires_grad_(False).eval()
            for d in mesh.devices[1:]]

    def _loss(self, outs, targets):
        spec, lk = self.bundle.spec, self.loss_kwargs
        if spec.family == "yolov7":
            return yolov7_loss(outs, targets, self.module.anchors,
                               spec.num_classes, **lk)
        if spec.family == "yolov8":
            return yolov8_loss(outs, targets, spec.num_classes, **lk)
        if spec.family == "xunet":
            return xunet_loss(outs, targets)
        raise NotImplementedError(spec.family)

    def loss_and_grads(self, state: Dict, images_u8, targets, names=None):
        """(loss, metrics, grads {name: tensor}, new batch_stats) for the
        leaves ``names`` (default: every parameter). ``images_u8`` and
        ``targets`` are this process's rows of the global batch (all of
        it, in one process)."""
        mesh, primary = self.mesh, self.bundle.device
        names = list(state["params"]) if names is None else names
        group = mesh.group if mesh.process_count > 1 else None
        rows = mesh.rows(images_u8.shape[0])
        # per distinct device: the leaves the shards there differentiate
        # (shards on one device share them, and autograd adds their
        # gradients) and the running statistics
        leaves, stats = {}, {}
        for d in mesh.distinct_devices:
            leaves[d] = {n: t.detach().to(d).requires_grad_(n in names)
                         for n, t in state["params"].items()}
            stats[d] = {n: t.to(d) for n, t in state["batch_stats"].items()}
        flat = [leaves[d][n] for d in mesh.distinct_devices for n in names]
        synced = self.bn_mode == "batch" and mesh.size > 1
        for m in self.shard_modules:
            set_bn_mode(m, self.bn_mode)
            clear_batch_stats(m)

        def run_all(tensors):
            """Every shard's forward (in lockstep when BN is synchronized,
            with a fresh ``_ShardSync``), over the leaves ``tensors`` (in
            ``flat``'s order)."""
            given = dict(zip(map(id, flat), tensors))
            use = {d: {n: given.get(id(t), t) for n, t in lv.items()}
                   for d, lv in leaves.items()}
            sync = _ShardSync(mesh.devices, group) if synced else None
            for k, m in enumerate(self.shard_modules):
                _set_bn_sync(m, None if sync is None else sync.hook(k))
            grad = torch.is_grad_enabled()      # thread-local: carried

            def forward(k):
                d, lo, hi = rows[k]
                with on_device(d), torch.set_grad_enabled(grad):
                    return _apply(self.shard_modules[k], use[d], stats[d],
                                  _images_in(images_u8[lo:hi], d))
            return _run_shards(forward, len(rows), lockstep=synced,
                               sync=sync)

        # the TF32 switch is process-wide: set once, around every shard
        try:
            with _f32_convs():
                if self.remat:
                    shape = []
                    outs = _Remat.apply(run_all, shape, *flat)
                    outs = _unflatten_outs(outs, shape)
                else:
                    outs = run_all(flat)
                g_outs = _gather_outs(outs, primary, group)
                g_targets = torch.as_tensor(targets, dtype=torch.float32) \
                    .to(primary)
                if group is not None:
                    g_targets = _GatherRows.apply(g_targets, group)
                loss, metrics = self._loss(g_outs, g_targets)
                got = torch.autograd.grad(loss, flat, materialize_grads=True)
        finally:
            for m in self.shard_modules:
                _set_bn_sync(m, None)
        # the gradient of the global loss: the sum over devices, then over
        # processes (one flat buffer, one all_reduce)
        per = len(names)
        grads = list(got[:per])
        for j in range(1, len(mesh.distinct_devices)):
            part = got[j * per:(j + 1) * per]
            grads = [g + p.to(primary) for g, p in zip(grads, part)]
        if group is not None:
            import torch.distributed as dist
            buf = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(buf, group=group)
            grads = [c.view_as(g) for c, g in zip(
                buf.split([g.numel() for g in grads]), grads)]
        new_bs = state["batch_stats"]
        if self.bn_mode == "batch":
            # every shard holds the global statistics: fold shard 0's
            new_bs = _fold_batch_stats(self.shard_modules[0], new_bs)
        for m in self.shard_modules:
            clear_batch_stats(m)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, dict(zip(names, grads)), new_bs

    def __call__(self, state: Dict, images_u8, targets):
        names = list(state["opt_state"]["mu"])
        loss, metrics, grads, new_bs = self.loss_and_grads(
            state, images_u8, targets, names)
        if self.freeze_prefixes and self.bn_mode != "frozen":
            new_bs = _restore_frozen_stats(state["batch_stats"], new_bs,
                                           self.freeze_prefixes)
        params, opt = self.tx.update(state["params"], grads,
                                     state["opt_state"])
        new_step = state["step"] + 1
        out = {"params": params, "batch_stats": new_bs, "opt_state": opt,
               "step": new_step}
        if self.ema_decay > 0.0:
            # the ultralytics EMA ramp: d·(1 − e^(−t/2000)), after the
            # step count is incremented
            d = np.float32(self.ema_decay) * (np.float32(1) - np.exp(
                np.float32(-new_step) / np.float32(2000.0)))
            ema = state["ema_params"]
            keys = list(ema)
            with torch.no_grad():
                new = torch._foreach_add(
                    torch._foreach_mul([ema[k] for k in keys], float(d)),
                    torch._foreach_mul([params[k] for k in keys],
                                       float(np.float32(1) - d)))
            out["ema_params"] = dict(zip(keys, new))
        return out, dict(metrics, loss=loss)


def make_train_step(bundle: ModelBundle, tx: AdamW,
                    mesh=None,
                    axis_name: str = "data",
                    loss_kwargs: Optional[Dict] = None,
                    bn_mode: str = "auto",
                    remat: bool = False,
                    ema_decay: float = 0.0,
                    freeze=None) -> TrainStep:
    """Returns ``(state, images_u8 [B,S,S,3], targets [B,T,5]) → (state,
    metrics)`` on the bundle's device.

    bn_mode: 'frozen' = BN applies its running statistics as a fixed
    affine during training too; 'batch' = batch statistics and flax's
    running-average update; 'auto' = ``resolve_bn_mode``. remat:
    activation checkpointing of the forward (``_Remat``: every shard's
    forward is recomputed in the backward, in lockstep as the first time;
    the running statistics update once). ema_decay > 0:
    keep an EMA of the params in ``state["ema_params"]``. freeze: as
    ``resolve_freeze_prefixes``; frozen layers' running statistics are put
    back after a batch-mode step (the optimizer's mask is ``tx``'s).

    mesh: a ``parallel/mesh.Mesh`` whose first device holds the bundle
    (and the state): the data-parallel step of the module docstring, equal
    to this step on the global batch. The local batch must divide evenly
    over the mesh's local devices; across processes every process passes
    its own rows (process-major) and gets the same new state. Without a
    mesh the step runs over a mesh of the bundle's one device.
    ``axis_name`` is the reference's; the mesh carries its own.
    """
    return TrainStep(bundle, tx, loss_kwargs=loss_kwargs, bn_mode=bn_mode,
                     remat=remat, ema_decay=ema_decay, freeze=freeze,
                     mesh=mesh)


# ------------------------------------------------------ data parallelism

def _set_bn_sync(module: torch.nn.Module, sync) -> None:
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.sync = sync


class _AllReduce(torch.autograd.Function):
    """Differentiable sum over the processes: the gradient of a sum that
    every process uses is the sum of their gradients."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """Each process's rows → the global rows in process order, on every
    process: an ``all_reduce`` of a zero buffer that holds this process's
    rows at its offset (exact: the other terms are zeros). Every process
    then computes the same loss, so the gradient of its own rows is its
    slice of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        n, r = dist.get_world_size(group), dist.get_rank(group)
        b = x.shape[0]
        ctx.rows = (r * b, (r + 1) * b)
        buf = x.new_zeros((n * b,) + tuple(x.shape[1:]))
        buf[r * b:(r + 1) * b] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None


def _gather_outs(outs, device: torch.device, group):
    """Per-shard head outputs (a tensor or a list of tensors each) → the
    global batch's, concatenated in shard order on ``device``, then over
    the processes."""
    def cat(ts):
        t = ts[0].to(device) if len(ts) == 1 \
            else torch.cat([x.to(device) for x in ts])
        return t if group is None else _GatherRows.apply(t, group)
    if isinstance(outs[0], torch.Tensor):
        return cat(outs)
    return type(outs[0])(cat(parts) for parts in zip(*outs))


class _ShardSync:
    """Adds ``batch``-mode BatchNorm's per-channel sums over every shard of
    the mesh, in the order the layers run. In-process shards meet at a
    barrier in each layer (their forwards run in lockstep threads) and
    each adds every shard's sums on its own device, in shard order, through
    autograd (so the gradient reaches every shard); across processes shard
    0 adds the process totals with a differentiable ``all_reduce`` while
    the other local shards wait for it. Every process has the same number
    of rows, so the global count is the local one times the process
    count."""

    def __init__(self, devices, group):
        self.devices = list(devices)
        self.group = group
        n = len(self.devices)
        self.barrier = threading.Barrier(n) if n > 1 else None
        self.rounds = []
        self.lock = threading.Lock()
        self.calls = [0] * n

    def abort(self):
        if self.barrier is not None:
            self.barrier.abort()

    def hook(self, k: int):
        return lambda sums, count: self(k, sums, count)

    def __call__(self, k: int, sums, count: int):
        r = self.calls[k]
        self.calls[k] += 1
        n = len(self.devices)
        with self.lock:
            while len(self.rounds) <= r:
                self.rounds.append({"sums": [None] * n, "total": None})
            rnd = self.rounds[r]
        rnd["sums"][k] = sums
        if self.barrier is not None:
            self.barrier.wait()
        dev = self.devices[k]
        total = rnd["sums"][0].to(dev)
        for other in rnd["sums"][1:]:
            total = total + other.to(dev)
        count = count * n
        if self.group is None:
            return total, count
        import torch.distributed as dist
        count = count * dist.get_world_size(self.group)
        if k == 0:
            rnd["total"] = _AllReduce.apply(total, self.group)
        if self.barrier is not None:
            self.barrier.wait()
        return rnd["total"].to(dev), count


def _flatten_outs(outs):
    """Per-shard outputs (a tensor or a list of tensors each) → (flat
    tensors, the count per shard, or None for a lone tensor)."""
    flat, shape = [], []
    for o in outs:
        if isinstance(o, torch.Tensor):
            flat.append(o)
            shape.append(None)
        else:
            flat.extend(o)
            shape.append(len(o))
    return flat, shape


def _unflatten_outs(flat, shape):
    outs, i = [], 0
    for n in shape:
        if n is None:
            outs.append(flat[i])
            i += 1
        else:
            outs.append(list(flat[i:i + n]))
            i += n
    return outs


class _Remat(torch.autograd.Function):
    """Activation checkpointing over every shard's forward at once:
    ``run(leaves)`` runs them keeping no activations; the backward runs
    them again, in lockstep as the first time (a synchronized BatchNorm
    meets the other shards and processes in the recomputation too, and
    keeps the statistics of the first forward), then differentiates the
    recomputed outputs. ``shape`` (a list) receives the outputs' layout."""

    @staticmethod
    def forward(ctx, run, shape, *leaves):
        ctx.run = run
        ctx.save_for_backward(*leaves)
        flat, layout = _flatten_outs(run(leaves))
        shape.extend(layout)
        return tuple(flat)

    @staticmethod
    def backward(ctx, *grads):
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            flat, _ = _flatten_outs(ctx.run(leaves))
        pairs = [(o, g) for o, g in zip(flat, grads)
                 if g is not None and o.requires_grad]
        want = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None) + tuple(next(got) if t.requires_grad else None
                                    for t in leaves)


def _run_shards(fn, n: int, lockstep: bool, sync=None):
    """[fn(k) for k < n]: in one thread per shard when the shards must run
    in lockstep (a synchronized BatchNorm), else one after another. A
    shard that fails breaks the others' barrier, and its error is
    raised."""
    if not lockstep or n == 1:
        return [fn(k) for k in range(n)]
    outs, errors = [None] * n, [None] * n

    def run(k):
        try:
            outs[k] = fn(k)
        except BaseException as e:          # re-raised on the caller
            errors[k] = e
            sync.abort()

    threads = [threading.Thread(target=run, args=(k,), name=f"shard-{k}")
               for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None and not isinstance(e, threading.BrokenBarrierError):
            raise e
    for e in errors:
        if e is not None:
            raise e
    return outs


# ------------------------------------------------------- BN, evaluation

def _weights(state: Dict):
    """(params to use — EMA when tracked —, batch_stats) of a state."""
    return (state.get("ema_params", state["params"]),
            state.get("batch_stats", {}))


@torch.no_grad()
def recalibrate_bn(bundle: ModelBundle, state: Dict, loader,
                   passes: int = 4, freeze_prefixes=()) -> Dict:
    """Recompute BatchNorm running statistics from the final weights:
    batch-mode forwards (statistics updating, parameters untouched) over
    ``loader.epoch(10_000 + p)`` for p < passes. Uses ``ema_params`` when
    the state has them. Frozen layers keep their original statistics.
    Returns the state with new ``batch_stats``; a no-op for models without
    batch_stats. ``state`` is the trainer's (``state_from_flax`` carries
    flax-format variables across)."""
    if not state.get("batch_stats"):
        return state
    module = _train_module(bundle)
    params, bs = _weights(state)
    start = bs
    set_bn_mode(module, "batch")
    with _f32_convs():
        for p in range(passes):
            for images, _targets in loader.epoch(10_000 + p):
                clear_batch_stats(module)
                _apply(module, params, bs, _images_in(images, bundle.device))
                bs = _fold_batch_stats(module, bs)
    clear_batch_stats(module)
    if freeze_prefixes:
        bs = _restore_frozen_stats(start, bs, freeze_prefixes)
    return dict(state, batch_stats=bs)


@torch.no_grad()
def evaluate(bundle: ModelBundle, state: Dict, loader,
             conf_threshold: float = 0.25) -> Dict[str, float]:
    """mAP over a validation loader (``ops/metrics.evaluate_detections``)
    after ``batched_nms`` at ``conf_threshold``, IoU 0.45, 512 candidates
    and 128 slots, class-aware; on the card the suppression is the NMS
    kernel. ``state`` is the trainer's (for a bundle's own weights:
    ``state_from_flax(bundle.variables, bundle.device)``); EMA weights are
    used when present."""
    from aerial_image_recognition_tpu_torch.ops.metrics import (
        evaluate_detections)
    from aerial_image_recognition_tpu_torch.ops.nms import batched_nms

    module = _train_module(bundle)
    params, stats = _weights(state)
    nc = bundle.spec.num_classes
    set_bn_mode(module, "frozen")
    preds, gts = [], []
    with _f32_convs():
        for images, targets in loader.epoch(0):
            outs = _apply(module, params, stats,
                          _images_in(images, bundle.device))
            boxes, scores = module.decode(outs, images.shape[1])
            det = batched_nms(boxes, scores, num_classes=nc,
                              conf_threshold=conf_threshold, max_det=128)
            valid = det.valid.cpu().numpy()
            det_boxes = det.boxes.cpu().numpy()
            det_cls = det.classes.cpu().numpy()
            det_scores = det.scores.cpu().numpy()
            for bi in range(images.shape[0]):
                v = valid[bi]
                preds.append({"boxes": det_boxes[bi][v],
                              "classes": det_cls[bi][v],
                              "scores": det_scores[bi][v]})
                t = np.asarray(targets[bi])
                tv = t[:, 0] >= 0
                gts.append({"boxes": t[tv][:, 1:], "classes": t[tv][:, 0]})
    return evaluate_detections(preds, gts, nc)


# ------------------------------------------------------------------ fit

def fit(bundle: ModelBundle, loader, *, epochs: int = 1,
        lr: float = 1e-4, mesh=None,
        eval_loader=None, eval_every: int = 1, eval_fn=None,
        conf_threshold: float = 0.25, log_fn=print,
        bn_mode: str = "auto", remat: bool = False,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 1,
        loss_kwargs: Optional[Dict] = None,
        lr_schedule: str = "constant", warmup_epochs: float = 0.0,
        final_lr_frac: float = 0.01, ema_decay: float = 0.0,
        freeze=None, patience: Optional[int] = None) -> Dict:
    """Train a detector (or XUnet with ``eval_fn``), the reference's
    ``fit`` step for step.

    ckpt_dir: saves the train state to ``epoch_N`` every ckpt_every
    epochs and resumes from the highest ``epoch_N`` found there.
    lr_schedule / warmup_epochs / final_lr_frac: 'cosine' or 'linear'
    decay toward lr·final_lr_frac with a warmup ramp. ema_decay: EMA of
    the weights (evaluation, recalibration and ``best`` prefer it).
    freeze: yaml layer indices and/or module-path prefixes trained not at
    all (no update, no decay, no BN-statistic drift). patience: stop when
    that many epochs pass without the fitness (0.1·mAP50 + 0.9·mAP50_95,
    ties going to the later epoch) improving; counted only at evals.
    eval_fn: ``(bundle, state) → {name: float}`` instead of the detection
    mAP; the state it gets is in the reference's format
    (``state_to_flax``). In ``batch`` BN mode the statistics are
    recalibrated (one pass) before each eval and (two passes) at the end.

    Returns the final state in the reference's format (flax-format numpy
    trees: ``registry.save_params({"params": …, "batch_stats": …})`` writes
    the checkpoint the JAX CLI writes), with ``best`` (params, batch_stats,
    epoch, fitness) when an eval produced a fitness, and ``history``.

    mesh: the data-parallel step (``make_train_step``) over the mesh; each
    loader batch is this process's rows of the global batch. Evaluation
    and recalibration run on the bundle's device, as the reference's run
    on its replicated state.
    """
    if getattr(getattr(loader, "cfg", None), "close_mosaic", 0):
        loader.total_epochs = epochs
    param_mask = None
    freeze_prefixes = resolve_freeze_prefixes(bundle, freeze)
    if freeze_prefixes:
        param_mask = _freeze_mask(bundle.variables["params"], freeze_prefixes)
    if lr_schedule == "constant" and not warmup_epochs:
        tx = make_optimizer(lr=lr, param_mask=param_mask)
    else:
        steps_per_epoch = getattr(loader, "steps_per_epoch", None)
        if steps_per_epoch is None:
            try:
                steps_per_epoch = max(
                    1, len(loader.samples) // max(loader.cfg.batch_size, 1))
            except AttributeError:
                raise ValueError(
                    "lr schedules need the steps-per-epoch: expose a "
                    "steps_per_epoch attribute on custom loaders") from None
        tx = make_optimizer(
            lr=lr, schedule=lr_schedule,
            total_steps=steps_per_epoch * epochs,
            warmup_steps=int(round(warmup_epochs * steps_per_epoch)),
            final_lr_frac=final_lr_frac, param_mask=param_mask)
    bn_mode = resolve_bn_mode(bundle, bn_mode)
    step_fn = make_train_step(bundle, tx, mesh=mesh, bn_mode=bn_mode,
                              remat=remat, loss_kwargs=loss_kwargs,
                              ema_decay=ema_decay, freeze=freeze_prefixes)
    state = init_train_state(bundle, tx, ema_decay=ema_decay)
    start_epoch = 0
    if ckpt_dir:
        from aerial_image_recognition_tpu_torch.runtime.train_ckpt import (
            load_train_state)
        done = sorted(int(d.split("_")[-1])
                      for d in os.listdir(ckpt_dir)
                      if re.fullmatch(r"epoch_\d+", d)) if os.path.isdir(
                          ckpt_dir) else []
        if done:
            start_epoch = done[-1] + 1
            path = os.path.join(ckpt_dir, f"epoch_{done[-1]}")
            try:
                state = load_train_state(path, state)
            except KeyError:
                if "ema_params" not in state:
                    raise
                # a checkpoint from before EMA tracking: restore without
                # it and seed the average from the restored weights
                tmpl = {k: v for k, v in state.items() if k != "ema_params"}
                state = load_train_state(path, tmpl)
                state["ema_params"] = {n: t.clone() for n, t in
                                       state["params"].items()}
            log_fn(f"resumed from epoch {done[-1]} "
                   f"(step {state['step']})")
    history = []
    best = None
    best_epoch = start_epoch - 1
    for epoch in range(start_epoch, epochs):
        losses = []
        stop_early = False
        for images, targets in loader.epoch(epoch):
            state, metrics = step_fn(state, images, targets)
            losses.append(float(metrics["loss"]))
        row = {"epoch": epoch, "loss": float(np.mean(np.asarray(
            losses, np.float32))) if losses else float("nan")}
        if ((eval_loader is not None or eval_fn is not None)
                and (epoch + 1) % eval_every == 0):
            if bn_mode == "batch":
                state = recalibrate_bn(bundle, state, loader, passes=1,
                                       freeze_prefixes=freeze_prefixes)
            if eval_fn is not None:
                row.update(eval_fn(bundle, state_to_flax(state)))
            else:
                row.update(evaluate(bundle, state, eval_loader,
                                    conf_threshold=conf_threshold))
            # ultralytics fitness; ties go to the later (more trained)
            # epoch, so a flat curve does not freeze the first eval
            if "fitness" not in row and "mAP50" in row:
                row["fitness"] = (0.1 * row["mAP50"]
                                  + 0.9 * row["mAP50_95"])
            if "fitness" not in row:
                pass                       # metrics logged only
            elif best is None or row["fitness"] >= best["fitness"]:
                if best is None or row["fitness"] > best["fitness"]:
                    best_epoch = epoch     # patience counts improvements
                params, stats = _weights(state)
                best = dict(state_to_flax({"params": params,
                                           "batch_stats": stats}),
                            epoch=epoch, fitness=row["fitness"])
            # early stop only right after an eval
            stop_early = (patience is not None and patience > 0
                          and best is not None
                          and epoch - best_epoch >= patience)
        history.append(row)
        log_fn(f"epoch {epoch}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in row.items() if k != "epoch"))
        if ckpt_dir and (epoch + 1) % ckpt_every == 0:
            from aerial_image_recognition_tpu_torch.runtime.train_ckpt import (
                save_train_state)
            save_train_state(state, os.path.join(ckpt_dir,
                                                 f"epoch_{epoch}"))
        if stop_early:
            log_fn(f"early stop at epoch {epoch}: fitness "
                   f"{best['fitness']:.4f} has not improved since epoch "
                   f"{best_epoch} (patience {patience})")
            break
    if bn_mode == "batch" and epochs > start_epoch:
        state = recalibrate_bn(bundle, state, loader, passes=2,
                               freeze_prefixes=freeze_prefixes)
    state = state_to_flax(state)
    if best is not None:
        state["best"] = best
    state["history"] = history
    return state
