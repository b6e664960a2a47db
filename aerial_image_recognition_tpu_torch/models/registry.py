"""Model registry: name → (module, decode, input contract).

Counterpart of ``aerial_image_recognition_tpu/models/registry.py``: every
detector the reference registers — ``yolov7_itcvd`` (YOLOv7-tiny, nc=1),
``yolov7_base`` (nc=1), ``yolov8_tokyo`` (YOLOv8l, nc=2 car/truck) and the
YOLOv8 n/s/m/l/x ladder (nc=2) — all at 640 px. The segmentation model
(``xunet_256``) arrives with its slice and is refused by name until then.
"""

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from aerial_image_recognition_tpu_torch.models.weights import (
    load_flax_into, load_params, params_to_flax)
from aerial_image_recognition_tpu_torch.models.yolov7 import YOLOv7
from aerial_image_recognition_tpu_torch.models.yolov8 import YOLOv8
from aerial_image_recognition_tpu_torch.runtime.device import resolve_device


@dataclass
class ModelSpec:
    name: str
    family: str                   # yolov7 | yolov8 | xunet
    num_classes: int
    input_size: int               # square input edge (pixels)
    make_module: Callable[[], nn.Module]
    class_names: Tuple[str, ...] = ()


REGISTRY: Dict[str, ModelSpec] = {
    # primary car detector: the car_aerial_detection_yolo7_ITCVD slot
    "yolov7_itcvd": ModelSpec("yolov7_itcvd", "yolov7", 1, 640,
                              lambda: YOLOv7(num_classes=1, variant="tiny"),
                              ("car",)),
    "yolov7_base": ModelSpec("yolov7_base", "yolov7", 1, 640,
                             lambda: YOLOv7(num_classes=1, variant="base"),
                             ("car",)),
    # the yolov8_tokyo_checkpoint slot: YOLOv8l, nc=2 {car, truck}
    "yolov8_tokyo": ModelSpec("yolov8_tokyo", "yolov8", 2, 640,
                              lambda: YOLOv8(num_classes=2, scale="l"),
                              ("car", "truck")),
}


def _yolov8_at_scale(sc):
    return lambda: YOLOv8(num_classes=2, scale=sc)


# every upstream yolov8 scale as its own slot: "yolov8n" builds the nano,
# not the Tokyo L model
for _sc in "nsmlx":
    REGISTRY[f"yolov8{_sc}"] = ModelSpec(
        f"yolov8{_sc}", "yolov8", 2, 640, _yolov8_at_scale(_sc),
        ("car", "truck"))

# names the reference registers that a later slice of the port brings
_LATER = ("xunet", "ramp")


def resolve_model_name(model_path: str) -> str:
    """Map reference-style model names and .onnx paths to registry names."""
    base = os.path.basename(model_path).lower()
    stem = os.path.splitext(base)[0]
    for name in (base, stem):            # "yolov8n.onnx" → yolov8n, not L
        if name in REGISTRY:
            return name
    if "yolo7" in base or "yolov7" in base or "itcvd" in base:
        return "yolov7_itcvd"
    if "yolov8" in base or "tokyo" in base:
        return "yolov8_tokyo"
    if any(tag in base for tag in _LATER):
        raise NotImplementedError(
            f"model {model_path!r} (xunet_256) arrives with the segmentation "
            "slice of the port")
    raise KeyError(f"cannot resolve model {model_path!r}")


@dataclass
class ModelBundle:
    """A constructed model on its device; the weights live in ``module``.

    ``variables`` is the f32 flax-format tree (numpy, on the host) the
    module was built from, before any BN fold or cast: int8 quantization
    (``models/int8.quantize_bundle``) reads the weights there, since the
    fused, cast module no longer has them."""
    spec: ModelSpec
    module: nn.Module
    device: torch.device
    variables: Optional[Dict] = None

    def forward(self, images: torch.Tensor):
        """images [B,3,S,S] (/255, trunk dtype) → (boxes [B,A,4] cxcywh
        pixels f32, scores [B,A,nc] f32)."""
        from aerial_image_recognition_tpu_torch.ops.decode import (
            decode_yolov7, decode_yolov8)
        outs = self.module(images)
        if self.spec.family == "yolov8":
            return decode_yolov8(outs, self.spec.num_classes)
        return decode_yolov7(outs, self.module.anchors,
                             self.spec.num_classes)

    def supports_s2d2(self) -> bool:
        """The quad-stem lowering is parked in the port: False for every
        family."""
        return False


def _prior_init_detect_bias(module: nn.Module, spec: ModelSpec) -> None:
    """Detection-prior bias init (the upstream yolo trick): objectness and
    class logits (yolov7) or the class logits (yolov8) start at σ(−5) ≈
    0.7 %. Only for fresh random weights."""
    with torch.no_grad():
        if spec.family == "yolov8":
            for i in range(3):
                getattr(module.detect, f"cls{i}_out").bias[:] = -5.0
            return
        no = 5 + module.num_classes
        for head in module.heads():
            for a in range(3):
                head.bias[a * no + 4:(a + 1) * no] = -5.0


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
    ``dtype``. The detect heads stay f32 either way.
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
        _prior_init_detect_bias(module, spec)
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
