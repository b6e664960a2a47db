"""The port's XUnet-256 (``models/xunet.py``), its registry entry,
``make_segment_fn`` and its int8 trunk against the JAX package's.

f32 on the CPU. Inputs are drawn from numpy seeds or rendered from the
FakeWorld's buildings (the world ``examples/train_xunet_fakeworld.py``
trained the fixture ``xunet_fakeworld.npz`` on; held-out tiles of seed
123, as tests/test_int8.py takes them). Tolerances, each stated where it
is used:

* raw logits within 1e-5 of their largest magnitude (the same convolutions
  summed in another order; BN folded here or not);
* ``make_segment_fn``'s probabilities within 5e-5 at 256 px (logits
  within ~1e-4, the sigmoid's slope at most 1/4) and 2e-3 at a 320-px
  window (the bf16 matrix resize of both packages first);
* int8, same ``absmax`` table: qparams and scales bit for bit; calibration
  tables within rtol 1e-5 (BN folded here, not there); the trunk on the
  same entry codes gives the codes of the JAX package's op-by-op chain
  exactly, and the f32 mask head on them logits within 1e-5; from the
  images the entry conv (BN unfolded in the JAX order) flips <= 1e-5 of
  the entry codes by one step, so the jitted JAX forward and the port's
  masks reach IoU >= 0.99; on the reference's entry codes the golden
  ``int8_xunet_trained.npz`` within atol 5e-3, rtol 1e-4, as
  tests/test_golden_regression.py holds the JAX package to it.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.fetch.fake import FakeWorld
from aerial_image_recognition_tpu.models import int8 as J
from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model, load_params as jax_load_params)
from aerial_image_recognition_tpu.models.xunet import XUnet as JaxXUnet
from aerial_image_recognition_tpu.ops.preprocess import (
    preprocess_batch as jax_preprocess_batch)
from aerial_image_recognition_tpu.pipeline.inference import (
    make_segment_fn as jax_make_segment_fn)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.models import int8 as P
from aerial_image_recognition_tpu_torch.models.layers import fold_batchnorm
from aerial_image_recognition_tpu_torch.models.registry import (
    create_model, save_params)
from aerial_image_recognition_tpu_torch.models.weights import (
    load_flax_into, load_params)
from aerial_image_recognition_tpu_torch.models.xunet import XUnet
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    make_segment_fn)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "xunet_fakeworld.npz")
SIZE = 256
WORLD_KW = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                n_cars=150, n_buildings=120, seed=4)

torch.set_num_threads(2)


def heldout_tiles(n=4, size=SIZE):
    """Held-out tiles of the training world (seed 123) and their masks."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from train_xunet_fakeworld import build_tiles
    world = FakeWorld(**WORLD_KW)
    boxes = build_tiles(world, n, size, 64.0, seed=123)
    tiles = np.stack([world.render(b, size, size) for b in boxes])
    masks = np.stack([world.render_mask(b, size, size) for b in boxes]) > 0
    return tiles, masks


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  tree)


@pytest.fixture(scope="module")
def trained():
    """The fixture in f32 in both packages, held-out tiles, the JAX
    package's calibration table of the first two and both quantized
    with that one table."""
    jb = jax_create_model("xunet_256", dtype=jnp.float32)
    jb.params = _f32(jax_load_params(FIXTURE))
    pb = create_model("xunet_256", params_path=FIXTURE, dtype=torch.float32,
                      device="cpu", fold_bn=True)
    tiles, masks = heldout_tiles()
    absmax = J.calibrate_absmax(jb, [tiles[:2]])
    jq = J.quantize_bundle(jb, [], absmax=absmax)
    pq = P.quantize_bundle(pb, [], absmax=absmax)
    return dict(jb=jb, pb=pb, tiles=tiles, masks=masks, absmax=absmax,
                jq=jq, pq=pq)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _close_to_max(got, want, frac=1e-5):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= frac * float(np.abs(want).max()), err


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("fold", [False, True], ids=["bn", "folded"])
def test_seeded_narrow_xunet_equals_jax(fold):
    """XUnet(base=8) with the JAX package's seeded init, BN statistics
    drawn from a numpy seed, 64-px inputs from a seed: logits within 1e-5
    of their largest magnitude, with BN as it is or folded."""
    rng = np.random.default_rng(11)
    jm = JaxXUnet(out_channels=1, base=8, dtype=jnp.float32)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3), x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    stats = variables["batch_stats"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]:
        node = stats
        for k in path[:-1]:
            node = node[k.key]
        name = path[-1].key
        node[name] = (rng.normal(0, 0.1, leaf.shape) if name == "mean"
                      else rng.uniform(0.5, 2.0, leaf.shape)) \
            .astype(np.float32)
    want = np.asarray(jm.apply(variables, x, train=False))
    pm = XUnet(out_channels=1, base=8)
    load_flax_into(pm, variables)
    pm.eval()
    if fold:
        fold_batchnorm(pm)
    with torch.inference_mode():
        got = pm(_nchw(x)).numpy()
    assert got.shape == (2, 64, 64, 1) and got.dtype == np.float32
    _close_to_max(got, want)


def test_trained_xunet_equals_jax(trained):
    """The trained fixture on two held-out tiles: logits within 1e-5 of
    their largest magnitude; the masks they give agree."""
    x = jax_preprocess_batch(jnp.asarray(trained["tiles"][:2]),
                             out_size=SIZE, dtype=jnp.float32)
    jb = trained["jb"]
    want = np.asarray(jax.jit(jb.forward)(jb.params, x))
    with torch.inference_mode():
        got = trained["pb"].forward(_nchw(x)).numpy()
    _close_to_max(got, want)
    assert _iou(got > 0, want > 0) >= 0.9999


def test_registry_entry_and_weights_round_trip(tmp_path):
    """``create_model("xunet_256")`` builds the registry's spec with a bf16
    trunk and an f32 head; ``save_params`` writes the reference's layout,
    which both packages read back to the same arrays."""
    b = create_model("ramp_XUnet_256.onnx", params_path=FIXTURE,
                     device="cpu")
    assert (b.spec.name, b.spec.family, b.spec.num_classes,
            b.spec.input_size, b.spec.class_names) == (
        "xunet_256", "xunet", 1, 256, ("building",))
    assert b.module.enc0.cv1.conv.weight.dtype == torch.bfloat16
    assert b.module.mask_out.weight.dtype == torch.float32
    out = str(tmp_path / "x.npz")
    save_params(b.variables, out)
    flat = dict(np.load(out))
    with np.load(FIXTURE) as ref:
        assert sorted(flat) == sorted(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)
    back = jax_load_params(out)
    again = load_params(out)
    np.testing.assert_array_equal(
        np.asarray(back["params"]["mask_out"]["kernel"]),
        again["params"]["mask_out"]["kernel"])


@pytest.mark.parametrize("window", [256, 320])
def test_make_segment_fn_equals_jax(trained, window):
    """uint8 tiles → probabilities [B,256,256,1] f32 on the CPU, at the
    model's 256 px (divide by 255) and at a 320-px window (both packages'
    bf16 matrix resize first): within 5e-5 and 2e-3."""
    tiles, _ = heldout_tiles(2, window)
    jcfg = JaxDetectorConfig(model_family="xunet", dtype="float32")
    jb = trained["jb"]
    want = np.asarray(jax.jit(jax_make_segment_fn(jb, jcfg))(jb.params,
                                                            tiles))
    fn = make_segment_fn(trained["pb"],
                         DetectorConfig(model_family="xunet",
                                        dtype="float32"))
    got = fn(tiles)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-5 if window == SIZE else 2e-3)


# -------------------------------------------------------------- int8

class _Names:
    """A trunk-graph interpreter that only records the conv names."""

    def __init__(self):
        self.names = []

    def conv(self, name, x, kernel, stride=1):
        self.names.append(name)
        return P.QT(None, 1.0, 0)

    def pool2(self, x):
        return x

    def up2(self, x):
        return x


def _xunet_conv_names():
    g = _Names()
    P._xunet_trunk(g, P.QT(None, 1.0, 32))
    return g.names


XUNET_CONVS = _xunet_conv_names()


def test_xunet_transcription_has_every_conv():
    """21 int8 convs: every ConvBN but the entry conv, each a multiple of
    4 channels wide (the epilogue kernel's vector path takes them all)."""
    assert len(XUNET_CONVS) == len(set(XUNET_CONVS)) == 21
    pb = create_model("xunet_256", device="cpu", dtype=torch.float32)
    for name in XUNET_CONVS:
        conv = pb.module.get_submodule(name.replace("/", ".")).conv
        assert conv.out_channels % 4 == 0, name


@pytest.mark.parametrize("name", XUNET_CONVS)
def test_int8_qparams_bit_equal(trained, name):
    jqp = trained["jq"].params["q"]["convs"][name]
    pqp = trained["pq"].params["q"]["convs"][name]
    assert set(pqp) == set(jqp) == {"w8", "m", "b"}
    for key in ("w8", "m", "b"):
        want = np.asarray(jqp[key])
        assert pqp[key].dtype == want.dtype and pqp[key].shape == want.shape
        np.testing.assert_array_equal(pqp[key], want)


def test_int8_scales_head_and_bridge(trained):
    """Static scales, the folded head kernel and its bias bit for bit;
    ``qparams_from_jax`` gives the same numpy q; only enc0 of the float
    tree rides along."""
    jq, pq = trained["jq"], trained["pq"]
    assert pq.static_scales == jq.static_scales
    assert pq.absmax == trained["absmax"]
    for key in ("mask_kernel", "mask_bias"):
        np.testing.assert_array_equal(pq.params["q"][key],
                                      np.asarray(jq.params["q"][key]))
    q = P.qparams_from_jax(jax.device_get(jq.params["q"]), jq.static_scales)
    assert q["scales"] == pq.static_scales
    for name in XUNET_CONVS:
        for key in ("w8", "m", "b"):
            np.testing.assert_array_equal(
                q["convs"][name][key], pq.params["q"]["convs"][name][key])
    assert set(pq.params["orig"]["params"]) == {"enc0"}
    assert {n.split(".")[0] for n, _ in pq.module.named_parameters()} == {
        "mask_out"}


def test_int8_calibrate_absmax_equals_jax(trained):
    """Every ConvBN output's absmax within rtol 1e-5 of the JAX package's
    (BN folded here, not there), over a running maximum of chunks."""
    got = P.calibrate_absmax(trained["pb"], [trained["tiles"][:1],
                                             trained["tiles"][1:2]])
    want = trained["absmax"]
    assert set(got) == set(XUNET_CONVS) | {"enc0/cv1"}
    assert set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)


def _jax_entry_codes(jq, x):
    t = J._xunet_entry(jq.params["orig"], x, dtype=jnp.float32)
    return np.asarray(jnp.clip(jnp.round(t / jq.static_scales["__entry__"]),
                               -127, 127).astype(jnp.int8))


def test_int8_trunk_codes_equal_jax_op_by_op(trained):
    """Bridged qparams and the JAX package's entry codes (two 128-px
    crops) into both trunks: the dec3 codes equal those of the JAX
    op-by-op chain exactly; the f32 head on them within 1e-5 of the
    logits' largest magnitude. The entry codes themselves differ on
    <= 1e-5 of them, by one step."""
    jq = trained["jq"]
    q = P.qparams_from_jax(jax.device_get(jq.params["q"]), jq.static_scales)
    pq = P.Int8XUnetBundle.from_q(trained["pb"].spec,
                                  trained["pb"].variables, q,
                                  dtype=torch.float32, device="cpu")
    x = jax_preprocess_batch(jnp.asarray(trained["tiles"][:2, :128, :128]),
                             out_size=128, dtype=jnp.float32)
    jxi = _jax_entry_codes(jq, x)
    with torch.inference_mode():
        pxi = pq.entry_codes(_nchw(x)).numpy()
    d = np.abs(pxi.astype(np.int32) - jxi.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-5
    g = J._Run(jq.params["q"]["convs"], act="relu", scales=jq.static_scales)
    want = J._xunet_trunk(g, J.QT(jnp.asarray(jxi), jq.static_scales[
        "__entry__"], jxi.shape[-1]))
    with torch.inference_mode():
        got = pq.trunk_codes(torch.from_numpy(jxi))
        logits = pq.module.mask_out(got.v.to(torch.float32)).numpy()
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    want_logits = np.asarray(jax.lax.conv_general_dilated(
        want.v.astype(jnp.float32), jq.params["q"]["mask_kernel"], (1, 1),
        ((0, 0), (0, 0)), dimension_numbers=J._DN)
        + jq.params["q"]["mask_bias"])
    _close_to_max(logits, want_logits)


def test_int8_forward_masks_match_jax_jitted(trained):
    """From the images, the jitted JAX forward against the port's: the
    entry codes' rare one-step flips (and XLA's fused requantization)
    move some logits, not the masks: IoU >= 0.99 on the 128-px quadrant
    of two tiles that holds the most building."""
    jq, pq = trained["jq"], trained["pq"]
    crops = []
    for k in range(2):
        r, c = max(((r, c) for r in (0, 128) for c in (0, 128)),
                   key=lambda rc: trained["masks"][k, rc[0]:rc[0] + 128,
                                                   rc[1]:rc[1] + 128].sum())
        crops.append(trained["tiles"][k, r:r + 128, c:c + 128])
    x = jax_preprocess_batch(jnp.asarray(np.stack(crops)), out_size=128,
                             dtype=jnp.float32)
    want = np.asarray(jax.jit(jq.forward)(jq.params, x))
    with torch.inference_mode():
        got = pq.forward(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 128, 128, 1)
    assert (want > 0).mean() >= 0.05
    assert _iou(got > 0, want > 0) >= 0.99


def test_int8_mask_parity_with_f32(trained):
    """The counterpart of tests/test_int8.py::test_int8_xunet_mask_parity
    on the port alone: int8 masks against the f32 model's at IoU >= 0.99,
    and ground-truth IoU no worse than f32's less 0.005 (two tiles)."""
    pb, pq = trained["pb"], trained["pq"]
    x = torch.from_numpy(trained["tiles"][2:]).permute(0, 3, 1, 2) \
        .float() / 255.0
    gt = trained["masks"][2:]
    with torch.inference_mode():
        mf = pb.forward(x).numpy()[..., 0] > 0
        mq = pq.forward(x).numpy()[..., 0] > 0
    assert _iou(mf, mq) >= 0.99
    assert _iou(mq, gt) >= _iou(mf, gt) - 0.005


def test_int8_xunet_golden(trained):
    """The recorded int8 logits of the JAX package
    (tests/test_golden_regression.py::test_int8_xunet_golden), for the
    same image quantized with its own calibration. On the reference's
    entry codes the port's trunk and head give the golden within atol
    5e-3, rtol 1e-4. From the image, the port's entry conv (another
    summation order, and ``torch.rsqrt`` where XLA's rsqrt differs in the
    last bit on 18 of the 32 channels) flips a few entry codes, which the
    trunk spreads: there the golden patch's signs agree on >= 0.99 of its
    pixels and the mean logit within 0.05."""
    gy, gx = np.mgrid[0:96, 0:96]
    img = (127 + 60 * np.sin(gx / 7.0) * np.cos(gy / 5.0)).astype(np.uint8)
    img = np.stack([img, np.roll(img, 3, 0), np.roll(img, 7, 1)], -1)
    img[30:40, 20:44] = 240
    img[60:68, 50:66] = 235
    img = np.tile(img[None], (1, 3, 3, 1))[:, :256, :256]
    absmax = J.calibrate_absmax(trained["jb"], [img])
    jq = J.quantize_bundle(trained["jb"], [], absmax=absmax)
    qb = P.quantize_bundle(trained["pb"], [], absmax=absmax)
    x = img.astype(np.float32) / 255.0
    jxi = _jax_entry_codes(jq, jnp.asarray(x))
    with torch.inference_mode():
        out = qb.trunk_codes(torch.from_numpy(jxi))
        on_ref = qb.module.mask_out(out.v.to(torch.float32)).numpy()
        own = qb.forward(_nchw(x)).numpy()
    with np.load(os.path.join(FIXTURES, "int8_xunet_trained.npz")) as ref:
        patch, mean = ref["logits_patch"], ref["logits_mean"]
    np.testing.assert_allclose(on_ref[0, 96:128, 96:128, 0], patch,
                               atol=5e-3, rtol=1e-4)
    np.testing.assert_allclose([float(on_ref.mean())], mean, atol=5e-3,
                               rtol=1e-4)
    assert ((own[0, 96:128, 96:128, 0] > 0) == (patch > 0)).mean() >= 0.99
    assert abs(float(own.mean()) - float(mean[0])) <= 0.05
