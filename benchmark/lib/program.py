"""What the benchmark takes from the program under test
(``aerial_image_recognition_tpu_torch``): its detect step, built as a
deployment builds it, and the program's own int8 path, which serves as the
control of ``correct`` (``--control int8``).

The step is ``pipeline.inference.build_detect_step`` over a bundle that
``models.registry.create_model`` builds from the weights the benchmark
made: trunk in the configuration's dtype, heads f32, BN folded; native
640-px tiles take the quad stem, as the deployment default.
"""

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def detector_config(config: dict, **overrides):
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    return DetectorConfig().merged(dict({
        "model_path": config["registry"], "model_family": config["family"],
        "num_classes": config["nc"], "dtype": config["dtype"]}, **overrides))


def bundle(config: dict, tree: dict, device):
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    return create_model(config["registry"], variables=tree,
                        dtype=DTYPES[config["dtype"]], device=device,
                        fold_bn=True)


def detect_step(cfg, model, devices, batch: int, *, src_size=None,
                control=None, calib=None):
    """The detect step over ``devices`` (a mesh when more than one).
    ``control="int8"``: the program's int8 trunk, calibrated on the uint8
    tiles ``calib`` [N,S,S,3]."""
    import dataclasses

    from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    if control == "int8":
        from aerial_image_recognition_tpu_torch.models.int8 import (
            quantize_bundle)
        model = quantize_bundle(model, [calib])
        cfg = dataclasses.replace(cfg, extra=dict(cfg.extra, quantize="int8"))
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    mesh = Mesh(devices) if len(devices) > 1 else None
    return build_detect_step(cfg, batch=batch, bundle=model,
                             src_size=src_size, mesh=mesh, device=devices[0])


def synchronize(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
