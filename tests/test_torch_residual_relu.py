"""The residual join of RT-DETR's ResNet-vd bottleneck
(``ops/residual_relu``): ``y ← max(y + s, 0)`` in place into the last
conv's output. On the CPU, the plain version inside ``Bottleneck`` and a
small ``RTDETR``, and the composite ``F.relu(y + s)`` kept where autograd
records; on a CUDA card (tests marked ``card``, skipped without one), the
kernel ``csrc/residual_relu.cu`` against the plain version.

Tolerance 0 throughout, compared as bits: the join's sum is rounded once
to the map's dtype and then clamped, which is what ``F.relu(y + s)``
computes, so every form gives the same bits.
"""

import pytest
import torch
import torch.nn.functional as F

from aerial_image_recognition_tpu_torch.models import rtdetr
from aerial_image_recognition_tpu_torch.models.rtdetr import (
    RTDETR, Bottleneck)
from aerial_image_recognition_tpu_torch.ops.residual_relu import (
    residual_relu, residual_relu_plain)

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]
FORMATS = {"contiguous": torch.contiguous_format,
           "channels_last": torch.channels_last}
# (c_in, c_out, stride): the identity shortcut of a stage's later blocks,
# the projected one of the first stage's first block, the average-pooled
# and projected one of a stage that halves the map
BLOCKS = {"identity": (32, 32, 1), "projected": (16, 32, 1),
          "pooled": (16, 32, 2)}
SMALL = dict(embedding_size=16, hidden_sizes=(32, 64, 96, 128),
             depths=(2, 1, 2, 1), hidden_dim=32, encoder_heads=2,
             encoder_ffn_dim=64, d_model=32, num_queries=20,
             decoder_layers=2, decoder_heads=2, decoder_ffn_dim=64)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits in logical order: equal bits, equal tensors
    (NaNs and the sign of zero included)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.contiguous().view(ints[t.dtype])


def _block(kind: str, dtype, fmt, seed: int = 0):
    """A seeded eval-mode ``Bottleneck`` with BN statistics of its own, in
    ``dtype`` and ``fmt``, and an input for it [2, c_in, 18, 18]."""
    c_in, c_out, stride = BLOCKS[kind]
    torch.manual_seed(seed)
    block = Bottleneck(c_in, c_out, stride, 1e-5)
    for m in block.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 2.0)
            m.weight.data.uniform_(0.5, 1.5)
            m.bias.data.uniform_(-0.5, 0.5)
    block = block.eval().to(dtype).to(memory_format=fmt)
    x = torch.randn(2, c_in, 18, 18).to(dtype).contiguous(memory_format=fmt)
    return block, x


def _join_operands(block, x):
    """(y, s) as ``Bottleneck.forward`` makes them."""
    y = block.cv3(block.cv2(block.cv1(x)))
    s = x
    if block.stride == 2:
        s = F.avg_pool2d(s, 2, 2, ceil_mode=True)
    if block.short is not None:
        s = block.short(s)
    return y, s


@pytest.mark.parametrize("kind", list(BLOCKS))
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_join_equals_composite_in_place(kind, fmt, dtype):
    """At a block's own operands the plain join gives the bits of
    ``F.relu(y + s)`` and returns y itself (its storage, its layout)."""
    block, x = _block(kind, dtype, FORMATS[fmt])
    with torch.inference_mode():
        y, s = _join_operands(block, x)
        assert (y + s).lt(0).any() and (y + s).gt(0).any()
        want = F.relu(y + s)
        ptr, strides = y.data_ptr(), y.stride()
        got = residual_relu(y, s)
    assert got is y and got.data_ptr() == ptr and got.stride() == strides
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_rtdetr_equals_the_composite_join(dtype, monkeypatch):
    """A seeded small RT-DETR under inference mode gives the bits of the
    same model with every join as ``F.relu(y + s)``, and takes the
    in-place join once a block (6 blocks)."""
    torch.manual_seed(23)
    model = RTDETR(2, **SMALL).eval().set_dtype(dtype) \
        .to(memory_format=torch.channels_last)
    x = torch.rand(2, 3, 128, 128).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    calls = []

    def counted(y, s):
        calls.append(tuple(y.shape))
        return residual_relu(y, s)
    monkeypatch.setattr(rtdetr, "residual_relu", counted)
    with torch.inference_mode():
        got = model(x)
    assert len(calls) == sum(SMALL["depths"])
    monkeypatch.setattr(rtdetr, "residual_relu",
                        lambda y, s: F.relu(y + s))
    with torch.inference_mode():
        want = model(x)
    assert set(got) == set(want)
    for k in want:
        if want[k].is_floating_point():
            assert torch.equal(_bits(got[k]), _bits(want[k])), k
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["identity", "pooled"])
@pytest.mark.parametrize("grads", ["params", "input", "none"])
def test_autograd_keeps_the_composite(kind, grads, monkeypatch):
    """Where autograd records (the block's weights or its input require
    grad) the block joins by ``F.relu(y + s)`` and back-propagates the
    composite's gradients; where nothing requires grad it joins in place,
    to the same output."""
    block, x = _block(kind, torch.float32, torch.channels_last)
    block.train()
    block.requires_grad_(grads == "params")
    x.requires_grad_(grads == "input")
    calls = []

    def counted(y, s):
        calls.append(1)
        return residual_relu(y, s)
    monkeypatch.setattr(rtdetr, "residual_relu", counted)
    out = block(x)
    y, s = _join_operands(block, x)
    want = F.relu(y + s)
    assert torch.equal(_bits(out), _bits(want))
    assert len(calls) == (1 if grads == "none" else 0)
    if grads == "none":
        assert not out.requires_grad
        return
    w = torch.linspace(-1, 1, out.numel()).view_as(out)
    leaves = list(block.parameters()) if grads == "params" else [x]
    got = torch.autograd.grad((out * w).sum(), leaves)
    ref = torch.autograd.grad((want * w).sum(), leaves)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# --- on a CUDA card -------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/residual_relu.cu has no CPU "
                    "mode")
    return torch.device("cuda")


def _special(shape, dtype, fmt, seed):
    """(y, s) on the CPU: normal values with NaNs, infinities, signed
    zeros and sums that round over bf16's largest value sown in."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=g) * 3
    s = torch.randn(shape, generator=g) * 3
    flat_y, flat_s = y.view(-1), s.view(-1)
    big = torch.finfo(dtype).max
    for i, (a, b) in enumerate([
            (float("nan"), 1.0), (1.0, float("nan")), (float("inf"), -1.0),
            (float("-inf"), 1.0), (float("inf"), float("-inf")),
            (-0.0, -0.0), (0.0, -0.0), (-0.0, 0.0), (big, big),
            (-big, -big), (1.0, -1.0)]):
        if i < flat_y.numel():
            flat_y[i], flat_s[i] = a, b
    return (y.to(dtype).contiguous(memory_format=fmt),
            s.to(dtype).contiguous(memory_format=fmt))


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 256, 20, 20), (3, 5, 7, 9),
                                   (1, 1, 1, 3)],
                         ids=["map", "ragged", "tail_only"])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel_equals_plain(card, shape, fmt, dtype):
    """The kernel gives every bit of ``F.relu(y + s)`` on the card, special
    values and a length that is no multiple of the 16-byte vector
    included, and the plain version's values on the CPU. Against the CPU
    two things are the platform's and are left out: a NaN's payload (the
    card makes 0x7fff in bf16, the CPU keeps 0x7fc0) and the sign of a
    zero sum (the card's ReLU gives +0 for -0 + -0, the CPU's keeps -0),
    so there the values are compared, and the NaNs' places."""
    y, s = _special(shape, dtype, FORMATS[fmt], 1)
    want = residual_relu_plain(y.clone(), s)
    yc, sc = y.to(card), s.to(card)
    on_card = F.relu(yc + sc)
    ptr = yc.data_ptr()
    got = residual_relu(yc, sc)
    torch.cuda.synchronize()
    assert got is yc and got.data_ptr() == ptr
    got = got.cpu()
    assert torch.equal(_bits(got), _bits(on_card.cpu()))
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.card
@pytest.mark.parametrize("case", ["mixed_layout", "float16", "shape",
                                  "dtype_pair", "strided", "misaligned"])
def test_kernel_refuses(card, case):
    """The wrapper raises, before any launch, on operands the kernel does
    not take."""
    cl = torch.channels_last
    y = torch.randn(2, 8, 6, 6, device=card).contiguous(memory_format=cl)
    s = torch.randn(2, 8, 6, 6, device=card).contiguous(memory_format=cl)
    if case == "mixed_layout":
        s = s.contiguous()
    elif case == "float16":
        y, s = y.half(), s.half()
    elif case == "shape":
        s = s[:1]
    elif case == "dtype_pair":
        s = s.bfloat16()
    elif case == "strided":
        y = torch.randn(2, 8, 6, 12, device=card)[..., ::2]
        s = torch.randn(2, 8, 6, 6, device=card)
    elif case == "misaligned":
        y = torch.randn(289, device=card)[1:]
        s = torch.randn(288, device=card)
    before = residual_relu.launches
    with pytest.raises(ValueError, match="residual_relu"):
        residual_relu(y, s)
    assert residual_relu.launches == before


@pytest.mark.card
def test_launches_count_kernel_calls(card):
    """One launch a call on the card; the plain version counts none."""
    y = torch.randn(4, 16, 8, 8, device=card)
    s = torch.randn(4, 16, 8, 8, device=card)
    before = residual_relu.launches
    for _ in range(3):
        residual_relu(y, s)
    residual_relu(y.cpu(), s.cpu())
    torch.cuda.synchronize()
    assert residual_relu.launches == before + 3
