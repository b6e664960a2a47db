"""Model registry: name → (module, decode, input contract).

Counterpart of ``aerial_image_recognition_tpu/models/registry.py``. This
slice carries the primary car detector only, ``yolov7_itcvd``
(YOLOv7-tiny, nc=1, 640 px); the other families arrive with their slice.
"""

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from aerial_image_recognition_tpu_torch.models.weights import (
    load_flax_into, load_params, params_to_flax)
from aerial_image_recognition_tpu_torch.models.yolov7 import YOLOv7
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
    "yolov7_itcvd": ModelSpec("yolov7_itcvd", "yolov7", 1, 640,
                              lambda: YOLOv7(num_classes=1, variant="tiny"),
                              ("car",)),
}

# names the reference registers that later slices of the port bring
_LATER = ("yolov7_base", "yolov8", "tokyo", "xunet", "ramp")


def resolve_model_name(model_path: str) -> str:
    """Map reference-style model names and .onnx paths to registry names."""
    base = os.path.basename(model_path).lower()
    stem = os.path.splitext(base)[0]
    for name in (base, stem):
        if name in REGISTRY:
            return name
    if any(tag in base for tag in _LATER):
        raise NotImplementedError(
            f"model {model_path!r} arrives with a later slice of the port; "
            "this slice has yolov7_itcvd only")
    if "yolo7" in base or "yolov7" in base or "itcvd" in base:
        return "yolov7_itcvd"
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
            decode_yolov7)
        outs = self.module(images)
        return decode_yolov7(outs, self.module.anchors,
                             self.spec.num_classes)


def _prior_init_detect_bias(module: YOLOv7) -> None:
    """Detection-prior bias init (the upstream yolo trick): objectness and
    class logits start at σ(−5) ≈ 0.7 %. Only for fresh random weights."""
    no = 5 + module.num_classes
    with torch.no_grad():
        for head in module.heads():
            for a in range(3):
                head.bias[a * no + 4:(a + 1) * no] = -5.0


def create_model(name: str = "yolov7_itcvd", *,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 params_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 fold_bn: bool = False) -> ModelBundle:
    """Build a registry model on ``device`` (default ``cuda``; raises
    without CUDA unless ``device`` is given).

    params_path: a reference-format npz checkpoint; without one the weights
    are random, drawn from ``seed``. fold_bn: fuse BN into the convs (the
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
        load_flax_into(module, variables)
    else:
        _prior_init_detect_bias(module)
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
