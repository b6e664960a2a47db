"""Guard tests for the port's rules.

The port package and chip_smoke.py import torch, numpy and the standard
library, never JAX, flax or the JAX package (whose name the port's shares as
a prefix, hence the exact top-level comparison). Entry points run on CUDA
unless given a device, and raise instead of falling back to the CPU.
"""

import ast
import dataclasses
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "aerial_image_recognition_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "aerial_image_recognition_tpu"}


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


def _imported_top_levels(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    bad = [(name, line) for name, line in _imported_top_levels(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_check_sees_the_prefix_package(tmp_path):
    """The check compares whole names: the port's own package passes, the
    JAX package of the same prefix, and imports inside functions, do not."""
    src = tmp_path / "snippet.py"
    src.write_text("import aerial_image_recognition_tpu_torch.ops\n"
                   "def f():\n"
                   "    from aerial_image_recognition_tpu.ops import nms\n"
                   "    import jax.numpy as jnp\n")
    found = [name in FORBIDDEN for name, _ in _imported_top_levels(src)]
    assert sorted(found) == [False, True, True]


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.pipeline.serve import (
        DetectionServer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (build_detect_step, create_model, DetectionServer):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(device="cuda")


def test_nms_wrapper_on_cpu_is_the_plain_version_and_builds_nothing(
        monkeypatch):
    """A CPU tensor goes to ``_suppress_plain`` and never near the kernel's
    build (there is no nvcc on a CPU-only machine)."""
    import numpy as np

    from aerial_image_recognition_tpu_torch.kernels import build
    from aerial_image_recognition_tpu_torch.ops.nms import _suppress_plain
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)

    def no_build(*a, **kw):
        raise AssertionError("the CPU path reached kernels.build")

    for name in ("load", "build_all", "_start", "_nvcc"):
        monkeypatch.setattr(build, name, no_build)
    rng = np.random.default_rng(5)
    boxes_t = torch.from_numpy(
        rng.uniform(0, 64, (2, 4, 24)).astype(np.float32))
    scores = torch.from_numpy(
        np.sort(rng.uniform(0, 1, (2, 24)).astype(np.float32))[:, ::-1]
        .copy())
    classes = torch.from_numpy(rng.integers(0, 3, (2, 24)).astype(np.int32))
    kw = dict(iou_threshold=0.45, max_det=8, class_aware=True)
    before = nms_suppress.launches
    got = nms_suppress(boxes_t, scores, classes, **kw)
    want = _suppress_plain(boxes_t, scores, classes, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert nms_suppress.launches == before


def test_unported_options_raise():
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    for extra in ({"quantize": "int8"}, {"quantize": "int8", "tta": True}):
        with pytest.raises(NotImplementedError, match="int8"):
            build_detect_step(DetectorConfig(extra=extra), device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        build_detect_step(device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        create_model("yolov8_tokyo", device="cpu")


def test_config_is_a_faithful_copy():
    from aerial_image_recognition_tpu.runtime.config import (
        DEFAULT_CONFIG as JAX_DEFAULT, DetectorConfig as JaxConfig)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DEFAULT_CONFIG, DetectorConfig)
    jf = [(f.name, f.type) for f in dataclasses.fields(JaxConfig)]
    pf = [(f.name, f.type) for f in dataclasses.fields(DetectorConfig)]
    assert pf == jf
    assert DEFAULT_CONFIG == JAX_DEFAULT
    d = {"confidence_threshold": 0.5, "nms_pre_topk": 128, "dtype": "float32"}
    assert DetectorConfig.from_dict(d).to_dict() == \
        JaxConfig.from_dict(d).to_dict()
    with pytest.raises(ValueError):
        DetectorConfig.from_dict({"tile_overlap": 1.5})


def test_decode_rgb_reads_png_and_jpeg_and_rejects_junk():
    import io

    import numpy as np
    from PIL import Image

    from aerial_image_recognition_tpu_torch.gio.decode import decode_rgb
    img = np.random.default_rng(0).integers(0, 255, (9, 7, 3), np.uint8)
    for fmt in ("PNG", "JPEG"):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt)
        out = decode_rgb(buf.getvalue())
        assert out.shape == (9, 7, 3) and out.dtype == np.uint8
        if fmt == "PNG":
            assert (out == img).all()
    assert decode_rgb(b"") is None and decode_rgb(b"not an image") is None
