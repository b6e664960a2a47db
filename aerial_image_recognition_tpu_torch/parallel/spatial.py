"""Spatial model-parallel inference: the image height sharded over a mesh.

Counterpart of ``aerial_image_recognition_tpu/parallel/spatial.py``, where
``jit`` with the height sharded is the whole implementation and GSPMD
inserts the halo exchange every convolution and pool needs at the shard
seams. Eager PyTorch has no such compiler, so the port shards the
activations itself: ``RowShards`` is an NCHW activation whose rows are
split over the mesh's devices (shard k holds rows ``edges[k]:edges[k+1]``
on ``devices[k]``), and its ``__torch_function__`` runs the trunk's
operations shard by shard:

* ``conv2d`` and ``max_pool2d`` compute each shard's output rows from the
  input rows they need, gathered from whichever shards hold them (the
  halo; SPP's chained 5×5 pools and a stride-2 conv alike), the image's
  top and bottom padded as the operation pads (zeros; −inf for a pool);
* nearest ``interpolate``, channel ``cat``/``chunk``/``split``, the
  activations, casts and elementwise arithmetic run on each shard's rows;
  ``space_to_depth2`` (``YOLOv7(s2d_stem=True)``'s entry) relays an even
  count of rows per output shard, taken from the shards that hold them;
* the heads' NHWC ``permute`` is where the rows meet: the whole map is
  gathered on the first device there, so decode, NMS and lon/lat run once,
  on replicated outputs, as the reference's ``out_shardings``;
* any other operation on row-sharded activations raises
  NotImplementedError: a mesh never quietly becomes its first device.

An ``Int8Bundle``'s float stems run whole on the first device and their
P2 codes are split by rows: a float sum over a slab of rows may round
otherwise than over the whole image (cuDNN picks its algorithm by shape;
on an H100, four slabs of 160 rows of a 64-tile batch flip 100 of
YOLOv7-tiny's P2 codes), and the integer trunk carries a flipped code to
the detections. Its int8
trunk runs on ``_Rows`` (NHWC codes split by rows) through ``_RowsRun``,
which gives each trunk operation (convolution, the pools, the upsample,
the residual add, the channel split) its halo rows in the same way, on
each device's copy of the int8 qparams, exactly on any slab; the head
taps meet on the first device.

Every activation of a given height is split the same way (``row_edges``),
so two of them always line up. The weights of a conv live on the bundle's
device; each other device gets a copy, made once per weight. On the card
this is for one high-priority tile's latency across cards; shards that
share a card run in turns.
"""

from dataclasses import replace
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from aerial_image_recognition_tpu_torch.models.layers import space_to_depth2
from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh


def row_edges(height: int, n: int) -> tuple:
    """Row boundaries of ``n`` shards of ``height`` rows (as even as
    integers allow; a shard may be empty)."""
    return tuple(k * height // n for k in range(n + 1))


class RowShards(torch.Tensor):
    """An NCHW tensor split by rows over devices (see the module
    docstring). ``parts[k]`` is [B, C, edges[k+1] − edges[k], W] on
    ``devices[k]``; the wrapper itself holds no storage."""

    @staticmethod
    def __new__(cls, parts, devices, weights=None):
        b, c, _, w = parts[0].shape
        height = sum(p.shape[2] for p in parts)
        out = torch.Tensor._make_wrapper_subclass(
            cls, (b, c, height, w), dtype=parts[0].dtype,
            device=devices[0])
        out.parts = list(parts)
        out.devices = tuple(devices)
        out.edges = row_edges(height, len(devices))
        out.weights = {} if weights is None else weights
        if [p.shape[2] for p in parts] != [
                out.edges[k + 1] - out.edges[k] for k in range(len(parts))]:
            raise ValueError("RowShards: parts do not follow row_edges")
        return out

    def __init__(self, parts, devices, weights=None):
        super().__init__()

    @classmethod
    def split(cls, x: torch.Tensor, devices, weights=None) -> "RowShards":
        """A whole [B, C, H, W] tensor → its rows over ``devices``."""
        e = row_edges(x.shape[2], len(devices))
        return cls([x[:, :, e[k]:e[k + 1]].to(d)
                    for k, d in enumerate(devices)], devices, weights)

    def like(self, parts) -> "RowShards":
        return RowShards(parts, self.devices, self.weights)

    def whole(self) -> torch.Tensor:
        """The full tensor on the first device."""
        return torch.cat([p.to(self.devices[0]) for p in self.parts], dim=2)

    def rows(self, start: int, stop: int, device, fill: float) -> torch.Tensor:
        """Rows ``start:stop`` (global; outside the image: ``fill``) on
        ``device``, taken from the shards that hold them."""
        return _take_rows(self.parts, self.edges, 2, start, stop, device,
                          fill)

    def param(self, t: Optional[torch.Tensor], device):
        """A weight on ``device``: itself where it lives, else a copy made
        once."""
        if t is None or t.device == device:
            return t
        key = (id(t), device)
        if key not in self.weights:
            self.weights[key] = t.to(device)
        return self.weights[key]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") == "__get__" \
                or func in _METADATA:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        handler = _HANDLERS.get(func)
        if handler is None and func in _EACH and not (
                func is torch.Tensor.to and any(
                    isinstance(a, (str, torch.device, torch.Tensor))
                    for a in args[1:] + tuple(kwargs.values()))):
            handler = _each               # a cast, not a move
        if handler is None:
            if func in _MEET:
                return _gathered(func, args, kwargs)
            _refuse(getattr(func, "__name__", str(func)))
        with torch._C.DisableTorchFunctionSubclass():
            return handler(func, *args, **kwargs)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        # every operation is taken at the __torch_function__ level above
        raise RuntimeError(f"RowShards reached {func} unsplit")


_METADATA = {torch.Tensor.dim, torch.Tensor.size, torch.Tensor.numel,
             torch.Tensor.is_contiguous, torch.Tensor.__repr__}
# the heads' NHWC permute: where the rows meet (see the module docstring)
_MEET = {torch.Tensor.permute, torch.permute}


def _refuse(what: str):
    raise NotImplementedError(
        f"spatial inference: {what} on row-sharded activations has no "
        "sharded rule; it would run the rest of the forward on one device")


def _take_rows(parts, edges, dim: int, start: int, stop: int, device,
               fill: float) -> torch.Tensor:
    """Global rows ``start:stop`` (dim ``dim``) of a tensor split as
    ``parts`` at ``edges``, on ``device``; rows outside the tensor are
    ``fill``."""
    height = edges[-1]
    pieces = []

    def filled(n):
        shape = list(parts[0].shape)
        shape[dim] = n
        return torch.full(shape, fill, dtype=parts[0].dtype, device=device)
    if start < 0:
        pieces.append(filled(min(0, stop) - start))
    for k, part in enumerate(parts):
        lo = max(start, edges[k])
        hi = min(stop, edges[k + 1])
        if lo < hi:
            pieces.append(part.narrow(dim, lo - edges[k], hi - lo)
                          .to(device))
    if stop > height:
        pieces.append(filled(stop - max(start, height)))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


def _first(args):
    for a in args:
        if isinstance(a, RowShards):
            return a
        if isinstance(a, (list, tuple)):
            found = _first(a)
            if found is not None:
                return found
    return None


def _whole(a):
    if isinstance(a, RowShards):
        return a.whole()
    if isinstance(a, (list, tuple)):
        return type(a)(_whole(x) for x in a)
    return a


def _gathered(func, args, kwargs):
    """The heads' permute: on the whole tensors, on the first device."""
    with torch._C.DisableTorchFunctionSubclass():
        return func(*_whole(args), **{k: _whole(v)
                                      for k, v in kwargs.items()})


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _window(func, x: RowShards, kernel_h: int, stride: int, pad: int,
            dilation: int, fill: float, run):
    """The shards of a windowed operation over rows: each output shard's
    input rows (its halo included) gathered onto its device, then
    ``run(slab, device, row_pad)``. Rows beyond the image are the
    operation's own padding (``row_pad``) where they are as many above as
    below (one shard: no copy at all), else rows of ``fill``."""
    height = x.edges[-1]
    span = dilation * (kernel_h - 1) + 1
    out_h = (height + 2 * pad - span) // stride + 1
    edges = row_edges(out_h, len(x.devices))
    parts = []
    for k, dev in enumerate(x.devices):
        o0, o1 = edges[k], edges[k + 1]
        if o0 == o1:
            # an empty shard: the operation on one window, none kept
            parts.append(run(x.rows(-pad, -pad + span, dev, fill), dev,
                             0)[:, :, :0])
            continue
        start = o0 * stride - pad
        stop = (o1 - 1) * stride - pad + span
        top, bottom = max(0, -start), max(0, stop - height)
        if top == bottom:
            parts.append(run(x.rows(start + top, stop - bottom, dev, fill),
                             dev, top))
        else:
            parts.append(run(x.rows(start, stop, dev, fill), dev, 0))
    return x.like(parts)


def _conv2d(func, x, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
    if not isinstance(x, RowShards) or isinstance(padding, str):
        _refuse(f"conv2d(padding={padding!r}) or a sharded weight")
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), \
        _pair(dilation)

    def run(slab, dev, row_pad):
        return F.conv2d(slab, x.param(weight, dev), x.param(bias, dev),
                        (sh, sw), (row_pad, pw), (dh, dw), groups)
    return _window(func, x, weight.shape[2], sh, ph, dh, 0.0, run)


def _max_pool2d(func, x, kernel_size, stride=None, padding=0, dilation=1,
                ceil_mode=False, return_indices=False):
    if ceil_mode or return_indices:
        _refuse("max_pool2d with ceil_mode or return_indices")
    (kh, kw) = _pair(kernel_size)
    (sh, sw) = _pair(stride if stride not in (None, []) else kernel_size)
    (ph, pw), (dh, dw) = _pair(padding), _pair(dilation)

    def run(slab, dev, row_pad):
        return F.max_pool2d(slab, (kh, kw), (sh, sw), (row_pad, pw),
                            (dh, dw))
    return _window(func, x, kh, sh, ph, dh, float("-inf"), run)


def _interpolate(func, x, size=None, scale_factor=None, mode="nearest",
                 align_corners=None, recompute_scale_factor=None,
                 antialias=False):
    s = scale_factor if isinstance(scale_factor, (int, float)) else None
    if mode != "nearest" or size is not None or s is None \
            or float(s) != int(s):
        _refuse(f"interpolate(mode={mode!r}, size={size}, "
                f"scale_factor={scale_factor})")
    s = int(s)
    edges = row_edges(x.edges[-1] * s, len(x.devices))
    parts = []
    for k, dev in enumerate(x.devices):
        o0, o1 = edges[k], edges[k + 1]
        lo = o0 // s
        slab = x.rows(lo, max(lo + 1, (o1 - 1) // s + 1), dev, 0.0)
        up = F.interpolate(slab, scale_factor=s, mode="nearest")
        parts.append(up[:, :, o0 - lo * s:o1 - lo * s])
    return x.like(parts)


def _space_to_depth2(func, x):
    """Each output shard's rows from input rows ``2·o0:2·o1`` (an even
    count, taken from whichever shards hold them), relaid on its device."""
    edges = row_edges(x.edges[-1] // 2, len(x.devices))
    return x.like([func(x.rows(2 * edges[k], 2 * edges[k + 1], dev, 0.0))
                   for k, dev in enumerate(x.devices)])


def _cat(func, tensors, dim=0, *, out=None):
    tensors = list(tensors)
    if out is not None or dim not in (1, -3) \
            or not all(isinstance(t, RowShards) for t in tensors):
        _refuse(f"cat over dim {dim}")
    x = tensors[0]
    return x.like([torch.cat([t.parts[k] for t in tensors], dim=1)
                   for k in range(len(x.devices))])


def _chunks(func, x, arg, dim=0):
    if dim not in (1, -3):
        _refuse(f"{func.__name__} over dim {dim}")
    per = [func(p, arg, dim=1) for p in x.parts]
    return tuple(x.like([pieces[j] for pieces in per])
                 for j in range(len(per[0])))


def _each(func, *args, **kwargs):
    """An elementwise operation (or a cast) shard by shard; other tensor
    arguments must not depend on the row (scalars, per-channel constants)
    and go to each shard's device."""
    x = _first(args)

    def on(a, k, dev):
        if isinstance(a, RowShards):
            if a.edges != x.edges:
                raise ValueError("RowShards of different heights meet")
            return a.parts[k]
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return a
    parts = [func(*(on(a, k, d) for a in args),
                  **{n: on(v, k, d) for n, v in kwargs.items()})
             for k, d in enumerate(x.devices)]
    return x.like(parts)


_HANDLERS = {F.conv2d: _conv2d, F.max_pool2d: _max_pool2d,
             F.interpolate: _interpolate, space_to_depth2: _space_to_depth2,
             torch.cat: _cat,
             torch.chunk: _chunks, torch.Tensor.chunk: _chunks,
             torch.split: _chunks, torch.Tensor.split: _chunks}
_EACH = {F.silu, F.relu, F.leaky_relu, torch.sigmoid, torch.Tensor.sigmoid,
         torch.relu, torch.Tensor.float, torch.Tensor.to,
         torch.Tensor.contiguous, torch.Tensor.__add__, torch.Tensor.__radd__,
         torch.Tensor.__mul__, torch.Tensor.__rmul__, torch.Tensor.__sub__,
         torch.Tensor.__truediv__, torch.Tensor.add, torch.Tensor.mul,
         torch.add, torch.mul}


class _Rows:
    """int8 NHWC codes split by rows (dim 1) over devices, as ``RowShards``
    splits an NCHW activation: ``parts[k]`` holds rows
    ``edges[k]:edges[k+1]`` on ``devices[k]``."""

    def __init__(self, parts, devices):
        self.parts = list(parts)
        self.devices = tuple(devices)
        self.edges = row_edges(sum(p.shape[1] for p in self.parts),
                               len(self.devices))
        if [p.shape[1] for p in self.parts] != [
                self.edges[k + 1] - self.edges[k]
                for k in range(len(self.parts))]:
            raise ValueError("_Rows: parts do not follow row_edges")

    @property
    def shape(self):
        b, _, w, c = self.parts[0].shape
        return (b, self.edges[-1], w, c)

    def rows(self, start: int, stop: int, device, fill: float):
        return _take_rows(self.parts, self.edges, 1, start, stop, device,
                          fill)

    def whole(self) -> torch.Tensor:
        return torch.cat([p.to(self.devices[0]) for p in self.parts], dim=1)


class _RowsRun:
    """The int8 trunk graph's operations (``models/int8._Run``'s) on
    ``_Rows``: each output shard's input rows, its halo included, are
    gathered onto its device and the device's ``_Run`` does the operation
    there; rows beyond the image are the operation's padding (zeros for a
    convolution, −128 for a pool)."""

    def __init__(self, runs, devices):
        self.runs = runs                  # {device: _Run}
        self.devices = tuple(devices)

    def _window(self, x: "_Rows", kernel: int, stride: int, pad: int,
                fill: float, op) -> "_Rows":
        # op(run, slab) pads ``pad`` rows itself; a slab that starts q
        # outputs early (a multiple of the stride) keeps its own padding
        # out of every output row that is kept
        height = x.shape[1]
        out_h = (height + 2 * pad - kernel) // stride + 1
        edges = row_edges(out_h, len(self.devices))
        q = -(-pad // stride)
        parts = []
        for k, dev in enumerate(self.devices):
            o0, o1 = edges[k], edges[k + 1]
            n = o1 - o0
            stop = (max(o1, o0 + 1) - 1) * stride - pad + kernel
            slab = x.rows((o0 - q) * stride, stop, dev, fill)
            parts.append(op(self.runs[dev], slab)[:, q:q + n])
        return _Rows(parts, self.devices)

    def conv(self, name, x, kernel, stride=1):
        from aerial_image_recognition_tpu_torch.models.int8 import QT
        xs = x if isinstance(x, list) else [x]
        v = xs[0].v if len(xs) == 1 else _Rows(
            [torch.cat([p.v.parts[k] for p in xs], dim=-1)
             for k in range(len(self.devices))], self.devices)
        s_in = xs[0].s
        scale = []

        def op(run, slab):
            out = run.conv(name, QT(slab, s_in, slab.shape[-1]), kernel,
                           stride)
            scale.append(out.s)
            return out.v
        out = self._window(v, kernel, stride, kernel // 2, 0.0, op)
        return QT(out, scale[0], out.shape[-1])

    def pool2(self, x):
        return replace(x, v=self._window(
            x.v, 2, 2, 0, -128.0,
            lambda run, slab: run.pool2(replace(x, v=slab)).v))

    def pool_same(self, x, k):
        return replace(x, v=self._window(
            x.v, k, 1, k // 2, -128.0,
            lambda run, slab: run.pool_same(replace(x, v=slab), k).v))

    def up2(self, x):
        height = x.v.shape[1]
        edges = row_edges(2 * height, len(self.devices))
        parts = []
        for k, dev in enumerate(self.devices):
            o0, o1 = edges[k], edges[k + 1]
            lo = o0 // 2
            slab = x.v.rows(lo, max(lo + 1, (o1 - 1) // 2 + 1), dev, 0.0)
            up = self.runs[dev].up2(replace(x, v=slab)).v
            parts.append(up[:, o0 - 2 * lo:o1 - 2 * lo])
        return replace(x, v=_Rows(parts, self.devices))

    def add(self, key, y, x):
        from aerial_image_recognition_tpu_torch.models.int8 import QT
        outs = [self.runs[d].add(key, replace(y, v=yp), replace(x, v=xp))
                for d, yp, xp in zip(self.devices, y.v.parts, x.v.parts)]
        return QT(_Rows([o.v for o in outs], self.devices), outs[0].s, y.c)

    def split2(self, x):
        pairs = [self.runs[d].split2(replace(x, v=p))
                 for d, p in zip(self.devices, x.v.parts)]
        return tuple(replace(pairs[0][j], v=_Rows([pr[j].v for pr in pairs],
                                                  self.devices))
                     for j in range(2))


class _SpatialBundle:
    """A bundle whose trunk runs on ``RowShards``: ``forward`` splits the
    preprocessed images by rows over the mesh, and the outputs come back
    whole on the first device. An ``Int8Bundle``'s float stems run whole
    on its device, and its int8 trunk on ``_Rows`` (``_RowsRun``) over a
    replica of its int8 qparams on each device."""

    def __init__(self, bundle, devices: Sequence[torch.device]):
        from aerial_image_recognition_tpu_torch.models.int8 import (
            Int8Bundle, _Run)
        self.bundle = bundle
        self.spec = bundle.spec
        self.device = bundle.device
        self.devices = tuple(devices)
        self.weights = {}
        self.int8 = None
        if isinstance(bundle, Int8Bundle):
            from aerial_image_recognition_tpu_torch.runtime.device import (
                canonical)
            replicas = {d: bundle if canonical(d) == canonical(bundle.device)
                        else bundle.to(d) for d in dict.fromkeys(self.devices)}
            self.int8 = (replicas, _RowsRun(
                {d: _Run(r.q["convs"], act=bundle.act,
                         scales=bundle.static_scales)
                 for d, r in replicas.items()}, self.devices))

    def forward(self, images: torch.Tensor):
        if self.int8 is None:
            return _whole(self.bundle.forward(
                RowShards.split(images, self.devices, self.weights)))
        from aerial_image_recognition_tpu_torch.models.int8 import (
            QT, _module_dtype)
        _, run = self.int8
        b = self.bundle
        # the float stems run whole: on the card their sums depend on the
        # slab's height (cuDNN picks its algorithm by shape), and a P2 code
        # that flips there moves the integer trunk's outputs; from the
        # codes on, every operation is exact on any slab
        codes = b._p2_quantize(b.module.stems(
            images.to(_module_dtype(b.module))))
        e = row_edges(codes.shape[1], len(self.devices))
        taps = b.trunk_codes(_Rows([codes[:, e[k]:e[k + 1]].to(d)
                                    for k, d in enumerate(self.devices)],
                                   self.devices), g=run)
        return b.decode(b.raw_from_taps([QT(t.v.whole(), t.s, t.c)
                                         for t in taps]))


def make_spatial_detect(bundle, cfg, mesh: Mesh, *, axis: str = "data",
                        model_size: Optional[int] = None):
    """(images_u8 [B,S,S,3], bounds [B,4]) → (Detections, lon, lat), the
    trunk's rows split over ``mesh``'s local devices (``axis`` is the
    reference's; the mesh has one), the outputs whole on the bundle's
    device. The function carries its weights (the reference's takes
    ``params``); host arrays are uploaded to the bundle's device first.
    The bundle lives on the mesh's first device."""
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        _upload, make_detect_fn)
    from aerial_image_recognition_tpu_torch.runtime.device import canonical
    if canonical(bundle.device) != canonical(mesh.devices[0]):
        raise ValueError(f"the bundle lives on {bundle.device}, the mesh "
                         f"starts at {mesh.devices[0]}")
    detect = make_detect_fn(_SpatialBundle(bundle, mesh.devices), cfg,
                            model_size=model_size)

    def run(images_u8, bounds):
        return detect(_upload(images_u8, bundle.device, torch.uint8),
                      _upload(bounds, bundle.device, torch.float32))
    return run
