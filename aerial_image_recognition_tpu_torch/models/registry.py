"""Model registry: name → (module, input contract); the module decodes.

Counterpart of ``aerial_image_recognition_tpu/models/registry.py``: every
detector the reference registers — ``yolov7_itcvd`` (YOLOv7-tiny, nc=1),
``yolov7_base`` (nc=1), ``yolov8_tokyo`` (YOLOv8l, nc=2 car/truck) and the
YOLOv8 n/s/m/l/x ladder (nc=2), all at 640 px, and the building
segmentation model ``xunet_256`` (XUnet, nc=1, 256 px), whose ``forward``
returns mask logits. Beyond the reference: ``rtdetr_r50vd``, RT-DETR with
a ResNet-50-vd backbone (nc=2 car/truck, 640 px), a set-prediction
detector whose step has no NMS (``pipeline/inference.make_detect_fn``).
"""

import copy
import os
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from aerial_image_recognition_tpu_torch.models.rtdetr import RTDETR
from aerial_image_recognition_tpu_torch.models.weights import (
    load_flax_into, load_params, params_to_flax)
from aerial_image_recognition_tpu_torch.models.xunet import XUnet
from aerial_image_recognition_tpu_torch.models.yolov7 import YOLOv7
from aerial_image_recognition_tpu_torch.models.yolov8 import YOLOv8
from aerial_image_recognition_tpu_torch.ops.quadstem import QuadStemEntry
from aerial_image_recognition_tpu_torch.runtime.device import resolve_device


@dataclass
class ModelSpec:
    """A registered model. What the model computes (its decode, its stem
    table, its detection prior, whether it ends without NMS) is asked of
    the module ``make_module`` builds, never decided here by name."""
    name: str
    family: str                   # yolov7 | yolov8 | rtdetr | xunet
    num_classes: int
    input_size: int               # square input edge (pixels)
    make_module: Callable[[], nn.Module]
    class_names: Tuple[str, ...] = ()
    arch: str = ""                # the yolov7 variant or yolov8 scale built


REGISTRY: Dict[str, ModelSpec] = {
    # primary car detector: the car_aerial_detection_yolo7_ITCVD slot
    "yolov7_itcvd": ModelSpec("yolov7_itcvd", "yolov7", 1, 640,
                              lambda: YOLOv7(num_classes=1, variant="tiny"),
                              ("car",), "tiny"),
    "yolov7_base": ModelSpec("yolov7_base", "yolov7", 1, 640,
                             lambda: YOLOv7(num_classes=1, variant="base"),
                             ("car",), "base"),
    # the yolov8_tokyo_checkpoint slot: YOLOv8l, nc=2 {car, truck}
    "yolov8_tokyo": ModelSpec("yolov8_tokyo", "yolov8", 2, 640,
                              lambda: YOLOv8(num_classes=2, scale="l"),
                              ("car", "truck"), "l"),
    # RT-DETR-R50 (ResNet-50-vd), the published widths, nc=2 {car, truck}
    "rtdetr_r50vd": ModelSpec("rtdetr_r50vd", "rtdetr", 2, 640,
                              lambda: RTDETR(num_classes=2),
                              ("car", "truck")),
    # the ramp_XUnet_256 slot: building footprints
    "xunet_256": ModelSpec("xunet_256", "xunet", 1, 256,
                           lambda: XUnet(out_channels=1), ("building",)),
}


def _yolov8_at_scale(sc):
    return lambda: YOLOv8(num_classes=2, scale=sc)


# every upstream yolov8 scale as its own slot: "yolov8n" builds the nano,
# not the Tokyo L model
for _sc in "nsmlx":
    REGISTRY[f"yolov8{_sc}"] = ModelSpec(
        f"yolov8{_sc}", "yolov8", 2, 640, _yolov8_at_scale(_sc),
        ("car", "truck"), _sc)

def resolve_model_name(model_path: str) -> str:
    """Map reference-style model names and .onnx paths to registry names."""
    base = os.path.basename(model_path).lower()
    stem = os.path.splitext(base)[0]
    for name in (base, stem):            # "yolov8n.onnx" → yolov8n, not L
        if name in REGISTRY:
            return name
    if "rtdetr" in base or "rt-detr" in base or "rt_detr" in base:
        return "rtdetr_r50vd"
    if "yolo7" in base or "yolov7" in base or "itcvd" in base:
        return "yolov7_itcvd"
    if "yolov8" in base or "tokyo" in base:
        return "yolov8_tokyo"
    if "xunet" in base or "ramp" in base:
        return "xunet_256"
    raise KeyError(f"cannot resolve model {model_path!r}")


@dataclass
class ModelBundle(QuadStemEntry):
    """A constructed model on its device; the weights live in ``module``.

    ``variables`` is the f32 flax-format tree (numpy, on the host) the
    module was built from, before any BN fold or cast: int8 quantization
    (``models/int8.quantize_bundle``) and the quad stem read the weights
    there, since the fused, cast module no longer has them. ``quad`` is the
    quad stem's ``ops/quadstem.QuadStem`` on the bundle's device, built from
    them at the first ``forward_s2d2`` (or carried over by ``to``)."""
    spec: ModelSpec
    module: nn.Module
    device: torch.device
    variables: Optional[Dict] = None
    quad: Any = field(default=None, repr=False)

    def forward(self, images: torch.Tensor):
        """images [B,3,S,S] (/255, trunk dtype) → the module's ``decode``
        of its outputs: (boxes [B,A,4] cxcywh pixels f32, scores [B,A,nc]
        f32); rtdetr: one box and the sigmoid class scores a query (A = the
        300 queries); xunet: mask logits [B,S,S,1] f32."""
        return self.module.decode(self.module(images), images.shape[-1])

    def to(self, device) -> "ModelBundle":
        """A replica on ``device`` (a data-parallel shard's): a copy of the
        module there; the host ``variables`` are shared."""
        device = torch.device(device)
        return replace(self, module=copy.deepcopy(self.module).to(device),
                       device=device,
                       quad=self.quad and self.quad.to(device))

    def trainable(self, device=None) -> nn.Module:
        """A new unfused f32 copy of the model for training: built from
        ``variables`` on ``device`` (default: the bundle's; channels_last),
        in train form — parameters that require grad, BN unfolded
        (``BatchNorm``, whose training modes ``models/layers.set_bn_mode``
        selects). The bundle's own module is not touched, as training
        leaves the reference's ``bundle.params`` alone."""
        if self.variables is None:
            raise ValueError("the bundle carries no flax-format variables "
                             "to train from")
        with torch.random.fork_rng(devices=[]):
            module = self.spec.make_module()
        load_flax_into(module, self.variables)
        return module.float().to(device=device or self.device,
                                 memory_format=torch.channels_last)

    def stem_variables(self) -> Dict:
        """The tree the quad stem is built from: ``variables``."""
        if self.variables is None:
            raise ValueError("the quad stem needs the f32 variables the "
                             "bundle was built from (bundle.variables)")
        return self.variables

    def forward_s2d2(self, xq: torch.Tensor, in_scale=1.0 / 255.0):
        """The quad-stem inference path: xq is the host-relayouted s2d²
        batch [B,S/4,S/4,48] (uint8 or float). The /255 folds into the
        stem's first conv; the trunk runs from the P2 feature
        (``from_p2``). Returns what ``forward`` returns."""
        outs = self.module(self.quad_stem()(xq, in_scale), from_p2=True)
        return self.module.decode(outs, 4 * xq.shape[1])


def create_model(name: str = "yolov7_itcvd", *,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 params_path: Optional[str] = None,
                 variables: Optional[Dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 fold_bn: bool = False) -> ModelBundle:
    """Build a registry model on ``device`` (default ``cuda``; raises
    without CUDA unless ``device`` is given).

    params_path: a reference-format npz checkpoint; variables: a flax-format
    tree instead (``models/import_torch.variables_from_torch_state`` makes
    one from upstream weights); without either the weights are random,
    drawn from ``seed``. fold_bn: fuse BN into the convs (the
    deploy form the detect step runs), done in f32 before the cast to
    ``dtype``. The detect heads (xunet: ``mask_out``) stay f32 either way.
    """
    device = resolve_device(device)
    spec = REGISTRY[resolve_model_name(name)]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = spec.make_module()
    if params_path:
        if not os.path.exists(params_path):
            raise FileNotFoundError(
                f"model checkpoint {params_path!r} does not exist — refusing "
                "to fall back to random weights")
        variables = load_params(params_path)
    if variables is not None:
        load_flax_into(module, variables)
    else:
        if hasattr(module, "init_detect_prior"):     # the YOLO families
            module.init_detect_prior()
        variables = params_to_flax(module)
    module.eval()
    if fold_bn:
        from aerial_image_recognition_tpu_torch.models.layers import (
            fold_batchnorm)
        fold_batchnorm(module)
    module.requires_grad_(False)
    module.set_dtype(dtype)
    module.to(device=device, memory_format=torch.channels_last)
    return ModelBundle(spec=spec, module=module, device=device,
                       variables=variables)


def save_params(params: Dict[str, Any], path: str) -> None:
    """Write a flax-format tree as the reference's flat-npz checkpoint,
    which both packages load (``models/weights.load_params`` here).

    Keys are the ``/``-joined tree paths, in the sorted order of the
    reference's tree flattening; bfloat16 leaves (torch tensors, or numpy
    arrays of an ``ml_dtypes`` bfloat16) are stored bit-exact as uint16
    under a ``:bf16`` key suffix, since numpy has no bfloat16 of its own;
    every other leaf is stored as it is."""
    from aerial_image_recognition_tpu_torch.models.weights import _flatten
    out: Dict[str, np.ndarray] = {}
    for keys, leaf in sorted(_flatten(params), key=lambda kl: kl[0]):
        key = "/".join(keys)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                out[key + ":bf16"] = leaf.view(torch.int16).numpy() \
                    .view(np.uint16)
                continue
            leaf = leaf.numpy()
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            out[key + ":bf16"] = arr.view(np.uint16)
        else:
            out[key] = arr
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez_compressed(f, **out)
