"""Weight import: upstream torch checkpoints → flax-format trees.

Copy of ``aerial_image_recognition_tpu/models/import_torch.py`` (numpy
only), the import half: the reference ships detector weights as ONNX/torch
blobs from the WongKinYiu/yolov7 and ultralytics lineages, and this module
holds the tested name/layout mapping that carries their state dicts into
the flax-format tree, from which ``models/weights.load_flax_into`` loads
the port's modules:

  * torch conv kernels [O, I, kh, kw] → flax [kh, kw, I, O]
  * torch BatchNorm (weight, bias, running_mean, running_var) →
    flax bn params (scale, bias) + batch_stats (mean, var)
  * yolov7 IDetect implicit layers (ia add / im mul) folded into the 1×1
    detect conv (the deploy fusion the ONNX export performs)

``export_torch_state`` is the inverse of the trunk mapping, and
``torch_state_from_variables`` of the whole import (the CLI's ``export``
verb); ``rtdetr_from_transformers`` carries an RT-DETR state dict with
``transformers``' names into the port's tree (no counterpart in the JAX
package, which has no RT-DETR); ``validate_variable_shapes`` is the shape report ``import-weights``
checks an imported tree with; ``layer_index_prefixes`` maps the upstream
yaml layer indices of a training freeze (``freeze=[0, 1, 2]``) to module
paths.
"""

from typing import Any, Dict, List, Tuple

import numpy as np


# --------------------------------------------------------------- helpers

def _conv_to_flax(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _conv_to_torch(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def _set(tree: Dict, path: List[str], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _get(tree: Dict, path: List[str]) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return node


# ------------------------------------------------------- mapping tables

# yolov7-tiny: upstream yaml layer index ↔ our module name
# (see models/yolov7.py _tiny; concat orders documented there)
_V7_TINY_CONVBN: List[Tuple[int, str]] = [
    (0, "stem0"), (1, "stem1"),
    (2, "elan1/cv1"), (3, "elan1/cv2"), (4, "elan1/cv3"),
    (5, "elan1/cv4"), (7, "elan1/out"),
    (9, "elan2/cv1"), (10, "elan2/cv2"), (11, "elan2/cv3"),
    (12, "elan2/cv4"), (14, "elan2/out"),
    (16, "elan3/cv1"), (17, "elan3/cv2"), (18, "elan3/cv3"),
    (19, "elan3/cv4"), (21, "elan3/out"),
    (23, "elan4/cv1"), (24, "elan4/cv2"), (25, "elan4/cv3"),
    (26, "elan4/cv4"), (28, "elan4/out"),
    (29, "sppcspc/cv1"), (30, "sppcspc/cv2"), (35, "sppcspc/cv3"),
    (37, "sppcspc/out"),
    (38, "up4_cv"), (40, "route4"),
    (42, "head_elan4/cv1"), (43, "head_elan4/cv2"),
    (44, "head_elan4/cv3"), (45, "head_elan4/cv4"), (47, "head_elan4/out"),
    (48, "up3_cv"), (50, "route3"),
    (52, "head_elan3/cv1"), (53, "head_elan3/cv2"),
    (54, "head_elan3/cv3"), (55, "head_elan3/cv4"), (57, "head_elan3/out"),
    (58, "down4_cv"),
    (60, "pan_elan4/cv1"), (61, "pan_elan4/cv2"),
    (62, "pan_elan4/cv3"), (63, "pan_elan4/cv4"), (65, "pan_elan4/out"),
    (66, "down5_cv"),
    (68, "pan_elan5/cv1"), (69, "pan_elan5/cv2"),
    (70, "pan_elan5/cv3"), (71, "pan_elan5/cv4"), (73, "pan_elan5/out"),
    (74, "out3"), (75, "out4"), (76, "out5"),
]
_V7_TINY_DETECT_IDX = 77

# yolov7 base: upstream cfg/deploy/yolov7.yaml layer index ↔ our module name
# (see models/yolov7.py _base). RepConv deploy-form layers (102-104) are
# handled separately in yolov7_base_mapping (rbr_reparam conv+bias, no BN).
_V7_BASE_CONVBN: List[Tuple[int, str]] = [
    (0, "stem0"), (1, "stem1"), (2, "stem2"), (3, "stem3"),
    (4, "elan1/cv1"), (5, "elan1/cv2"), (6, "elan1/m1"), (7, "elan1/m2"),
    (8, "elan1/m3"), (9, "elan1/m4"), (11, "elan1/out"),
    (13, "mp3/pool_cv"), (14, "mp3/pre_cv"), (15, "mp3/down_cv"),
    (17, "elan2/cv1"), (18, "elan2/cv2"), (19, "elan2/m1"), (20, "elan2/m2"),
    (21, "elan2/m3"), (22, "elan2/m4"), (24, "elan2/out"),
    (26, "mp4/pool_cv"), (27, "mp4/pre_cv"), (28, "mp4/down_cv"),
    (30, "elan3/cv1"), (31, "elan3/cv2"), (32, "elan3/m1"), (33, "elan3/m2"),
    (34, "elan3/m3"), (35, "elan3/m4"), (37, "elan3/out"),
    (39, "mp5/pool_cv"), (40, "mp5/pre_cv"), (41, "mp5/down_cv"),
    (43, "elan4/cv1"), (44, "elan4/cv2"), (45, "elan4/m1"), (46, "elan4/m2"),
    (47, "elan4/m3"), (48, "elan4/m4"), (50, "elan4/out"),
    (52, "up4_cv"), (54, "route4"),
    (56, "head_elan4/cv1"), (57, "head_elan4/cv2"),
    (58, "head_elan4/m1"), (59, "head_elan4/m2"), (60, "head_elan4/m3"),
    (61, "head_elan4/m4"), (63, "head_elan4/out"),
    (64, "up3_cv"), (66, "route3"),
    (68, "head_elan3/cv1"), (69, "head_elan3/cv2"),
    (70, "head_elan3/m1"), (71, "head_elan3/m2"), (72, "head_elan3/m3"),
    (73, "head_elan3/m4"), (75, "head_elan3/out"),
    (77, "pan4_pool_cv"), (78, "pan4_pre_cv"), (79, "pan4_down_cv"),
    (81, "pan_elan4/cv1"), (82, "pan_elan4/cv2"),
    (83, "pan_elan4/m1"), (84, "pan_elan4/m2"), (85, "pan_elan4/m3"),
    (86, "pan_elan4/m4"), (88, "pan_elan4/out"),
    (90, "pan5_pool_cv"), (91, "pan5_pre_cv"), (92, "pan5_down_cv"),
    (94, "pan_elan5/cv1"), (95, "pan_elan5/cv2"),
    (96, "pan_elan5/m1"), (97, "pan_elan5/m2"), (98, "pan_elan5/m3"),
    (99, "pan_elan5/m4"), (101, "pan_elan5/out"),
]
_V7_BASE_SPPCSPC_IDX = 51
_V7_BASE_REPCONV: List[Tuple[int, str]] = [
    (102, "rep3"), (103, "rep4"), (104, "rep5")]
_V7_BASE_DETECT_IDX = 105


def _v8_module_names(depth_n: Dict[str, int]) -> List[Tuple[str, str]]:
    """(torch prefix, our module name) for the yolov8 graph.

    depth_n: bottleneck counts per C2f (resolved from the scale).
    """
    pairs = [
        ("model.0", "stem"), ("model.1", "down2"), ("model.2", "c2f1"),
        ("model.3", "down3"), ("model.4", "c2f2"), ("model.5", "down4"),
        ("model.6", "c2f3"), ("model.7", "down5"), ("model.8", "c2f4"),
        ("model.9", "sppf"),
        ("model.12", "fpn4"), ("model.15", "fpn3"),
        ("model.16", "pan_down4"), ("model.18", "pan4"),
        ("model.19", "pan_down5"), ("model.21", "pan5"),
    ]
    return pairs


# ----------------------------------------------------------- conversion

def _convbn_pairs(torch_prefix: str, flax_name: str):
    """(torch key, flax path, transform) for one ConvBN block."""
    fp = flax_name.split("/")
    return [
        (f"{torch_prefix}.conv.weight", ["params"] + fp + ["conv", "kernel"],
         "conv"),
        (f"{torch_prefix}.bn.weight", ["params"] + fp + ["bn", "scale"], ""),
        (f"{torch_prefix}.bn.bias", ["params"] + fp + ["bn", "bias"], ""),
        (f"{torch_prefix}.bn.running_mean",
         ["batch_stats"] + fp + ["bn", "mean"], ""),
        (f"{torch_prefix}.bn.running_var",
         ["batch_stats"] + fp + ["bn", "var"], ""),
    ]


def yolov7_tiny_mapping() -> List[Tuple[str, List[str], str]]:
    out = []
    for idx, name in _V7_TINY_CONVBN:
        out.extend(_convbn_pairs(f"model.{idx}", name))
    return out


def yolov7_base_mapping() -> List[Tuple[str, List[str], str]]:
    out = []
    for idx, name in _V7_BASE_CONVBN:
        out.extend(_convbn_pairs(f"model.{idx}", name))
    for sub in ("cv1", "cv2", "cv3", "cv4", "cv5", "cv6", "cv7"):
        out.extend(_convbn_pairs(f"model.{_V7_BASE_SPPCSPC_IDX}.{sub}",
                                 f"sppcspc/{sub}"))
    for idx, name in _V7_BASE_REPCONV:
        # deploy-form RepConv = fused conv + bias (rbr_reparam), no BN
        out.append((f"model.{idx}.rbr_reparam.weight",
                    ["params", name, "conv", "kernel"], "conv"))
        out.append((f"model.{idx}.rbr_reparam.bias",
                    ["params", name, "conv", "bias"], ""))
    return out


def yolov8_mapping(n_c2f: Dict[str, int]) -> List[Tuple[str, List[str], str]]:
    out = []
    for tp, ours in _v8_module_names(n_c2f):
        if ours.startswith(("c2f", "fpn", "pan4", "pan5")):
            out.extend(_convbn_pairs(f"{tp}.cv1", f"{ours}/cv1"))
            out.extend(_convbn_pairs(f"{tp}.cv2", f"{ours}/cv2"))
            for i in range(n_c2f[ours]):
                out.extend(_convbn_pairs(f"{tp}.m.{i}.cv1", f"{ours}/m{i}/cv1"))
                out.extend(_convbn_pairs(f"{tp}.m.{i}.cv2", f"{ours}/m{i}/cv2"))
        elif ours == "sppf":
            out.extend(_convbn_pairs(f"{tp}.cv1", "sppf/cv1"))
            out.extend(_convbn_pairs(f"{tp}.cv2", "sppf/cv2"))
        else:
            out.extend(_convbn_pairs(tp, ours))
    # detect head: model.22.cv2 = box branch, cv3 = cls branch
    for lvl in range(3):
        for branch, ours in (("cv2", "box"), ("cv3", "cls")):
            for j, tail in ((0, "cv1"), (1, "cv2")):
                out.extend(_convbn_pairs(
                    f"model.22.{branch}.{lvl}.{j}",
                    f"detect/{ours}{lvl}_{tail}"))
            out.append((f"model.22.{branch}.{lvl}.2.weight",
                        ["params", "detect", f"{ours}{lvl}_out", "kernel"],
                        "conv"))
            out.append((f"model.22.{branch}.{lvl}.2.bias",
                        ["params", "detect", f"{ours}{lvl}_out", "bias"], ""))
    return out


def import_torch_state(state_dict: Dict[str, np.ndarray],
                       mapping: List[Tuple[str, List[str], str]]
                       ) -> Dict[str, Any]:
    """torch-style {name: array} → flax variables {'params','batch_stats'}."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    missing = []
    for tkey, fpath, kind in mapping:
        if tkey not in state_dict:
            missing.append(tkey)
            continue
        v = np.asarray(state_dict[tkey])
        if kind == "conv":
            v = _conv_to_flax(v)
        _set(tree, fpath, v)
    if missing:
        raise KeyError(f"{len(missing)} keys missing from state dict, e.g. "
                       f"{missing[:5]}")
    return tree


def export_torch_state(variables: Dict[str, Any],
                       mapping: List[Tuple[str, List[str], str]]
                       ) -> Dict[str, np.ndarray]:
    """Inverse of import_torch_state (used by the round-trip tests)."""
    out = {}
    for tkey, fpath, kind in mapping:
        v = np.asarray(_get(variables, fpath))
        if kind == "conv":
            v = _conv_to_torch(v)
        out[tkey] = v
    return out


def fold_idetect(conv_w: np.ndarray, conv_b: np.ndarray,
                 ia: np.ndarray, im: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold yolov7 IDetect implicit layers into the 1×1 detect conv
    (the deploy fusion): y = im·(W(x + ia) + b) ⇒
    W' = im·W, b' = im·(b + W·ia)."""
    o, i = conv_w.shape[:2]
    w2 = conv_w.reshape(o, i)
    b_new = (conv_b + w2 @ ia.reshape(-1)) * im.reshape(-1)
    w_new = conv_w * im.reshape(-1, 1, 1, 1)
    return w_new, b_new


def yolov7_detect_from_torch(state_dict, variables, *,
                             detect_idx: int = _V7_TINY_DETECT_IDX):
    """Import the (I)Detect head: model.{detect_idx}.m.{i} convs + ia/im
    folding into our detect{i} flax convs (77 for tiny, 105 for base)."""
    import copy
    variables = copy.deepcopy(variables)
    for lvl in range(3):
        w = np.asarray(state_dict[f"model.{detect_idx}.m.{lvl}.weight"])
        b = np.asarray(state_dict[f"model.{detect_idx}.m.{lvl}.bias"])
        ia_key = f"model.{detect_idx}.ia.{lvl}.implicit"
        im_key = f"model.{detect_idx}.im.{lvl}.implicit"
        if ia_key in state_dict:
            w, b = fold_idetect(w, b, np.asarray(state_dict[ia_key]),
                                np.asarray(state_dict[im_key]))
        _set(variables, ["params", f"detect{lvl}", "kernel"], _conv_to_flax(w))
        _set(variables, ["params", f"detect{lvl}", "bias"], b)
    return variables


# the tiny-specific spelling of the reference's earlier call sites
yolov7_tiny_detect_from_torch = yolov7_detect_from_torch


def yolov7_detect_to_torch(variables, *,
                           detect_idx: int = _V7_TINY_DETECT_IDX
                           ) -> Dict[str, np.ndarray]:
    """Inverse of yolov7_detect_from_torch, in the deploy (folded) form:
    our detect{lvl} convs already carry ia/im folded in (the fusion the
    reference's ONNX export performed), so the exported state holds only
    model.{detect_idx}.m.{lvl}.{weight,bias} with no ia/im keys — importing
    it back skips the fold and reproduces the identical flax weights."""
    out = {}
    for lvl in range(3):
        k = np.asarray(_get(variables, ["params", f"detect{lvl}", "kernel"]))
        b = np.asarray(_get(variables, ["params", f"detect{lvl}", "bias"]))
        out[f"model.{detect_idx}.m.{lvl}.weight"] = _conv_to_torch(k)
        out[f"model.{detect_idx}.m.{lvl}.bias"] = b
    return out


def torch_state_from_variables(variables: Dict[str, Any],
                               model_name: str) -> Dict[str, np.ndarray]:
    """Inverse of variables_from_torch_state: the complete upstream-named
    tensor set (trunk mapping + detect heads) for a registry model. The
    CLI's ``export`` verb writes it with ``onnx_lite.write_minimal_onnx``,
    a way back to the reference's onnxruntime flow for every detection
    family."""
    from aerial_image_recognition_tpu_torch.models.registry import (
        REGISTRY, resolve_model_name)
    spec = REGISTRY[resolve_model_name(model_name)]
    if spec.family == "yolov7":
        if spec.arch == "base":
            out = export_torch_state(variables, yolov7_base_mapping())
            out.update(yolov7_detect_to_torch(
                variables, detect_idx=_V7_BASE_DETECT_IDX))
        else:
            out = export_torch_state(variables, yolov7_tiny_mapping())
            out.update(yolov7_detect_to_torch(variables))
        return out
    if spec.family == "yolov8":
        return export_torch_state(variables,
                                  yolov8_mapping(yolov8_n_c2f(spec.arch)))
    raise KeyError(f"no torch export mapping for model family "
                   f"{spec.family!r} ({spec.name})")


def yolov8_n_c2f(scale: str) -> Dict[str, int]:
    """Per-module bottleneck counts for a yolov8 scale (the n_c2f dict
    yolov8_mapping needs)."""
    from aerial_image_recognition_tpu_torch.models.yolov8 import SCALES, _n
    d = SCALES[scale][0]
    n3, n6 = _n(3, d), _n(6, d)
    return {"c2f1": n3, "c2f2": n6, "c2f3": n6, "c2f4": n3,
            "fpn4": n3, "fpn3": n3, "pan4": n3, "pan5": n3}


def layer_index_prefixes(model_name: str) -> Dict[int, List[str]]:
    """Upstream yaml layer index → the module-path prefixes of the flax
    tree ('elan1/cv1', 'detect0', ...) — the ultralytics ``freeze=[0,1,2]``
    addressing, through the same index tables the weight bridge uses.
    Indices of parameterless layers (maxpool, upsample, concat) have no
    entry."""
    from aerial_image_recognition_tpu_torch.models.registry import (
        REGISTRY, resolve_model_name)
    spec = REGISTRY[resolve_model_name(model_name)]
    out: Dict[int, List[str]] = {}
    if spec.family == "yolov7":
        base = spec.arch == "base"
        for idx, mod in _V7_BASE_CONVBN if base else _V7_TINY_CONVBN:
            out.setdefault(idx, []).append(mod)
        if base:
            out[_V7_BASE_SPPCSPC_IDX] = ["sppcspc"]
            for idx, mod in _V7_BASE_REPCONV:
                out[idx] = [mod]
            detect_idx = _V7_BASE_DETECT_IDX
        else:
            detect_idx = _V7_TINY_DETECT_IDX
        out[detect_idx] = ["detect0", "detect1", "detect2"]
        return out
    if spec.family == "yolov8":
        for tp, mod in _v8_module_names({}):
            out[int(tp.split(".")[1])] = [mod]
        out[22] = ["detect"]
        return out
    raise KeyError(f"no upstream layer-index table for family "
                   f"{spec.family!r} ({spec.name})")


def variables_from_torch_state(state_dict: Dict[str, np.ndarray],
                               model_name: str) -> Dict[str, Any]:
    """Full turnkey import: upstream torch-named {name: array} → the flax
    variables tree for a registry model (weight mapping + detect-head
    fold). This is the one call between a dropped-in reference blob
    (``models/onnx_lite.load_onnx_initializers`` or
    ``models/torch_pt.load_checkpoint_state``) and a runnable model:
    ``models/weights.load_flax_into`` takes the tree it returns."""
    from aerial_image_recognition_tpu_torch.models.registry import (
        REGISTRY, resolve_model_name)
    spec = REGISTRY[resolve_model_name(model_name)]
    if spec.family == "yolov7":
        if spec.arch == "base":
            variables = import_torch_state(state_dict, yolov7_base_mapping())
            return yolov7_detect_from_torch(state_dict, variables,
                                            detect_idx=_V7_BASE_DETECT_IDX)
        variables = import_torch_state(state_dict, yolov7_tiny_mapping())
        return yolov7_detect_from_torch(state_dict, variables,
                                        detect_idx=_V7_TINY_DETECT_IDX)
    if spec.family == "yolov8":
        return import_torch_state(state_dict,
                                  yolov8_mapping(yolov8_n_c2f(spec.arch)))
    if spec.family == "rtdetr":
        return rtdetr_from_transformers(state_dict)
    raise KeyError(f"no torch import mapping for model family "
                   f"{spec.family!r} ({spec.name})")


# RT-DETR (transformers' RTDetrForObjectDetection names) → the port's
# module paths (models/rtdetr.py): (pattern, path template, kind), the
# kind deciding the leaves; the first match wins
_RTDETR_RULES: List[Tuple[str, str, str]] = [
    (r"model\.backbone\.model\.embedder\.embedder\.(\d+)\.(convolution|"
     r"normalization)", "backbone/stem{0}", "cbn"),
    (r"model\.backbone\.model\.encoder\.stages\.(\d+)\.layers\.(\d+)\."
     r"shortcut\.(?:1\.)?(convolution|normalization)",
     "backbone/s{0}/b{1}/short", "cbn"),
    (r"model\.backbone\.model\.encoder\.stages\.(\d+)\.layers\.(\d+)\."
     r"layer\.(\d+)\.(convolution|normalization)",
     "backbone/s{0}/b{1}/cv{2+}", "cbn"),
    (r"model\.encoder_input_proj\.(\d+)\.([01])", "encoder/proj{0}",
     "cbn"),
    (r"model\.encoder\.encoder\.0\.layers\.0\.self_attn\.([qkv]|out)_proj",
     "encoder/aifi/attn/{0}", "linear"),
    (r"model\.encoder\.encoder\.0\.layers\.0\.self_attn_layer_norm",
     "encoder/aifi/ln1", "ln"),
    (r"model\.encoder\.encoder\.0\.layers\.0\.(fc[12])",
     "encoder/aifi/{0}", "linear"),
    (r"model\.encoder\.encoder\.0\.layers\.0\.final_layer_norm",
     "encoder/aifi/ln2", "ln"),
    (r"model\.encoder\.lateral_convs\.(\d+)\.(conv|norm)",
     "encoder/lateral{0}", "cbn"),
    (r"model\.encoder\.downsample_convs\.(\d+)\.(conv|norm)",
     "encoder/down{0}", "cbn"),
    (r"model\.encoder\.(fpn|pan)_blocks\.(\d+)\.bottlenecks\.(\d+)\."
     r"conv1\.(conv|norm)", "encoder/{0}{1}/m{2}/c3", "cbn"),
    (r"model\.encoder\.(fpn|pan)_blocks\.(\d+)\.bottlenecks\.(\d+)\."
     r"conv2\.(conv|norm)", "encoder/{0}{1}/m{2}/c1", "cbn"),
    (r"model\.encoder\.(fpn|pan)_blocks\.(\d+)\.conv([12])\.(conv|norm)",
     "encoder/{0}{1}/cv{2}", "cbn"),
    (r"model\.decoder_input_proj\.(\d+)\.([01])", "decoder/proj{0}",
     "cbn"),
    (r"model\.enc_output\.0", "decoder/enc_output", "linear"),
    (r"model\.enc_output\.1", "decoder/enc_norm", "ln"),
    (r"model\.enc_score_head", "decoder/enc_score", "linear"),
    (r"model\.enc_bbox_head\.layers\.(\d+)", "decoder/enc_bbox/l{0}",
     "linear"),
    (r"model\.decoder\.query_pos_head\.layers\.(\d+)",
     "decoder/query_pos/l{0}", "linear"),
    (r"model\.decoder\.layers\.(\d+)\.self_attn\.([qkv]|out)_proj",
     "decoder/layer{0}/attn/{1}", "linear"),
    (r"model\.decoder\.layers\.(\d+)\.self_attn_layer_norm",
     "decoder/layer{0}/ln1", "ln"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn\.sampling_offsets",
     "decoder/layer{0}/cross/offsets", "linear"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn\.attention_weights",
     "decoder/layer{0}/cross/weights", "linear"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn\.value_proj",
     "decoder/layer{0}/cross/value", "linear"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn\.output_proj",
     "decoder/layer{0}/cross/out", "linear"),
    (r"model\.decoder\.layers\.(\d+)\.encoder_attn_layer_norm",
     "decoder/layer{0}/ln2", "ln"),
    (r"model\.decoder\.layers\.(\d+)\.(fc[12])", "decoder/layer{0}/{1}",
     "linear"),
    (r"model\.decoder\.layers\.(\d+)\.final_layer_norm",
     "decoder/layer{0}/ln3", "ln"),
    (r"(?:model\.decoder\.)?class_embed\.(\d+)", "decoder/class{0}",
     "linear"),
    (r"(?:model\.decoder\.)?bbox_embed\.(\d+)\.layers\.(\d+)",
     "decoder/bbox{0}/l{1}", "linear"),
]
# training-only tensors of the upstream model, not part of inference
_RTDETR_SKIP = ("model.denoising_class_embed.", "num_batches_tracked")


def _rtdetr_leaf(kind: str, leaf: str, value: np.ndarray, conv: bool):
    """(collection, leaf path under the module, array) of one upstream
    tensor of a ConvBN, linear or layer norm."""
    if kind == "cbn" and conv:
        return "params", ["conv", "kernel"], _conv_to_flax(value)
    if kind == "cbn":
        return {"weight": ("params", ["bn", "scale"]),
                "bias": ("params", ["bn", "bias"]),
                "running_mean": ("batch_stats", ["bn", "mean"]),
                "running_var": ("batch_stats", ["bn", "var"])}[leaf] \
            + (value,)
    if kind == "linear":
        if leaf == "weight":
            return "params", ["kernel"], value.T[None, None]
        return "params", ["bias"], value
    return "params", ["scale" if leaf == "weight" else "bias"], value


def rtdetr_from_transformers(state_dict: Dict[str, np.ndarray]
                             ) -> Dict[str, Any]:
    """An RT-DETR state dict with ``transformers``' parameter names
    (``RTDetrForObjectDetection.state_dict()``, e.g. the PekingU
    checkpoints, numpy or torch values) → the port's flax-format tree
    (``models/rtdetr.py``). The denoising class embedding is training-only
    and dropped; the decoder heads, which the upstream model holds under
    two names, are read from either. Raises on a name no rule maps."""
    import re
    rules = [(re.compile(p + r"\.(\w+)$"), t, k) for p, t, k in _RTDETR_RULES]
    tree: Dict[str, Any] = {}
    for name, value in state_dict.items():
        if any(s in name for s in _RTDETR_SKIP):
            continue
        for rx, template, kind in rules:
            m = rx.fullmatch(name)
            if m is None:
                continue
            *groups, leaf = m.groups()
            conv = kind == "cbn" and groups[-1] in ("convolution", "conv",
                                                    "0")
            if kind == "cbn":
                groups = groups[:-1]
            path = template.replace("{2+}", str(int(groups[-1]) + 1)) \
                if "{2+}" in template else template
            path = path.format(*groups)
            if hasattr(value, "detach"):
                value = value.detach().cpu().numpy()
            coll, leaf_path, arr = _rtdetr_leaf(kind, leaf, np.asarray(
                value, np.float32), conv)
            _set(tree, [coll] + path.split("/") + leaf_path, arr)
            break
        else:
            raise KeyError(f"no RT-DETR mapping for upstream tensor {name}")
    return tree


def validate_variable_shapes(variables: Dict[str, Any],
                             reference: Dict[str, Any]) -> None:
    """Compare two variable trees leaf by leaf; raise listing every shape
    mismatch (a clear error instead of silently wrong inference when an
    imported blob does not match the chosen registry model)."""
    from aerial_image_recognition_tpu_torch.models.weights import _flatten
    a, b = ({"/".join(path): np.shape(leaf) for path, leaf in _flatten(t)}
            for t in (variables, reference))
    problems = []
    for k in sorted(set(a) | set(b)):
        if k not in a:
            problems.append(f"missing from import: {k} {b[k]}")
        elif k not in b:
            problems.append(f"unexpected in import: {k} {a[k]}")
        elif a[k] != b[k]:
            problems.append(f"shape mismatch: {k} imported {a[k]} "
                            f"vs model {b[k]}")
    if problems:
        raise ValueError(
            f"{len(problems)} import/model inconsistencies, e.g.:\n  "
            + "\n  ".join(problems[:10]))
