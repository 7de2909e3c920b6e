"""The conv epilogue (`pmf_tpu_torch/ops/epilogue.py`) on the CPU: its plain
twin against PyTorch's unfused chain of ops, the nets' eval forwards through
it against the unfused ones, when the nets take it, how many passes a
forward makes, and what the wrapper refuses. The kernel itself runs only on
the card (tests/test_torch_cuda.py)."""
import pytest
import torch
import torch.nn.functional as F

from pmf_tpu_torch.models import EPMFNet, PMFNet, SalsaNext, random_weights
from pmf_tpu_torch.models import layers as L
from pmf_tpu_torch.models import pmf as pmf_models
from pmf_tpu_torch.ops import epilogue as E
from pmf_tpu_torch.ops.resize import pixel_shuffle
from tests.torch_threads import one_torch_thread  # noqa: F401

# (act, BN after it, residual, post): each variant a call site of the nets takes,
# and the remaining activations
VARIANTS = {
    "bias": (None, False, False, None),               # logits, ASPP's merge, RGBDecoder's head
    "relu": ("relu", False, False, None),             # conv_bn with relu
    "sigmoid": ("sigmoid", False, False, None),       # the fusion block's attention
    "leaky_relu": ("leaky_relu", False, False, None),  # SalsaNext's shortcuts
    "leaky_relu_bn": ("leaky_relu", True, False, None),  # SalsaNext's blocks, fusion, decoders
    "leaky_relu_bn_residual": ("leaky_relu", True, True, None),  # the blocks' last convs
    "residual_relu": (None, False, True, "relu"),     # BasicBlock's, Bottleneck's last conv_bn
    "relu_bn_residual_relu": ("relu", True, True, "relu"),
    "sigmoid_bn": ("sigmoid", True, False, None),
}


def operands(variant, dtype, c=24, seed=0):
    """A conv output y [2, c, 5, 7] channels-last in `dtype`, a float32 bias,
    an eval BN with random statistics (or None), a residual (or None)."""
    act, with_bn, with_res, post = VARIANTS[variant]
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(2, c, 5, 7, generator=g) * 2).to(dtype).contiguous(
        memory_format=torch.channels_last)
    bias = torch.randn(c, generator=g) * 0.5
    bn = None
    if with_bn:
        bn = L.BatchNorm2d(c).eval()
        with torch.no_grad():
            bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
            bn.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
            bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    res = torch.randn(y.shape, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last) if with_res else None
    return y, bias, act, bn, res, post


def twin(y, bias, act, bn, res, post):
    a, b = (None, None) if bn is None else bn.fold()
    return E.conv_epilogue_plain(y, bias, act, a, b, res, post)


@pytest.mark.parametrize("variant", VARIANTS)
def test_twin_equals_the_chain_in_float32(variant):
    """In float32 the twin is PyTorch's chain of ops after a conv with its
    bias, bit for bit: the bias, the activation, the eval BN's x·a + b, the
    residual, the closing relu (`layers._chain`, as the modules run it)."""
    y, bias, act, bn, res, post = operands(variant, torch.float32)
    want = L._chain(y + bias[:, None, None], act, bn, res, post)
    got = twin(y.clone(), bias, act, bn, res, post)
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_twin_rounds_once_in_bf16(variant):
    """On bf16 y the twin computes in float32 from y and the residual as they
    are and rounds once: the float32 chain on the same values, cast to bf16;
    in place, in y's layout."""
    y, bias, act, bn, res, post = operands(variant, torch.bfloat16)
    want = L._chain(y.float() + bias[:, None, None], act, bn,
                    None if res is None else res.float(), post).to(torch.bfloat16)
    out = y.clone()
    got = twin(out, bias, act, bn, res, post)
    assert got is out and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def test_conv_block_off_the_card_is_the_modules_chain():
    """Where the gate is closed (here: the CPU), conv_block and conv_bn are
    the modules' own ops: conv with its bias, LeakyReLU, BN, the residual;
    the folded conv_bn with relu(out + x)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, 8, 9, generator=g).contiguous(memory_format=torch.channels_last)
    conv, bn = L.Conv2d(6, 6, 3, padding=1), L.BatchNorm2d(6).eval()
    with torch.no_grad():
        conv.bias.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(torch.rand(6, generator=g) + 0.5)
        got = L.conv_block(x, conv, "leaky_relu", bn, residual=x)
        want = x + bn(L.leaky_relu(conv(x)))
        assert torch.equal(got, want)
        got = L.conv_bn(x, conv, bn, residual=x, post="relu")
        a, b = bn.fold()
        folded = conv._conv_forward(x, conv.weight * a[:, None, None, None], conv.bias * a + b)
        assert torch.equal(got, F.relu(folded + x))


def test_pixel_shuffle_keeps_channels_last_in_inference():
    """A channels-last input gives a channels-last output with
    F.pixel_shuffle's values, in inference and with grad on (so that the
    train-mode epilogues after it take their kernels too), and the gradient
    is F.pixel_shuffle's."""
    x = torch.randn(2, 16, 4, 6).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = pixel_shuffle(x, 2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, F.pixel_shuffle(x.contiguous(), 2))
    xg = x.clone().requires_grad_()
    yg = pixel_shuffle(xg, 2)
    assert yg.is_contiguous(memory_format=torch.channels_last) and torch.equal(yg, y)
    gout = torch.randn(y.shape)
    yg.backward(gout)
    assert torch.equal(xg.grad, F.pixel_unshuffle(gout, 2))


def card_gate(monkeypatch):
    """The gate as on the card, less its CUDA test: a bf16 4-d tensor
    contiguous in channels_last. The wrapper then runs the twin (the CPU
    path), counting each pass; and ASPP takes its kernel's path (on the CPU
    its plain branches into the NHWC buffer), as on the card."""
    monkeypatch.setattr(E, "epilogue_takes", lambda t: (
        t.dtype == torch.bfloat16 and t.dim() == 4
        and t.is_contiguous(memory_format=torch.channels_last)))
    monkeypatch.setattr(pmf_models, "aspp_takes", lambda t: True)


class Recorder:
    """Stands in for `conv_epilogue` where the nets call it: counts the
    calls and passes each on to the wrapper (on CPU tensors its checks, then
    the twin)."""

    def __init__(self, monkeypatch):
        self.calls, self.wrapper = 0, E.conv_epilogue
        monkeypatch.setattr(L.epilogue, "conv_epilogue", self)

    def __call__(self, *args):
        self.calls += 1
        return self.wrapper(*args)


# the passes an eval forward makes, by counting its convs. PMF-ResNet34: the
# lidar stream 64 (3 context blocks x 3, 5 resBlocks x 5, 4 fusion blocks x 3,
# ASPP's merge, 4 upBlocks x 4, the logits), ResNet34 36 (the stem, 16 blocks x
# 2, 3 downsamples), the RGBDecoder 5 (4 stages, the head). EPMF-ResNet34: the
# lidar stream 56 (no sparse context blocks; extraUpSample), ResNet34 36, the
# RGBDecoderV2 7 (extraUpSample, ASPP's merge, 4 stages, the head).
# PMF-ResNet50: ResNet50 53 (the stem, 16 blocks x 3, 4 downsamples).
# SalsaNext: 3 context blocks x 3, 5 resBlocks x 5, 4 upBlocks x 4, the logits.
NETS = {"pmf_r34": (lambda dt: PMFNet(nclasses=20, base_channels=8, image_backbone="resnet34",
                                      dtype=dt), 105),
        "epmf_r34": (lambda dt: EPMFNet(nclasses=20, base_channels=8, image_backbone="resnet34",
                                        dtype=dt), 99),
        "pmf_r50": (lambda dt: PMFNet(nclasses=20, base_channels=8, image_backbone="resnet50",
                                      dtype=dt), 122),
        "salsanext": (lambda dt: SalsaNext(nclasses=20, base_channels=8, dtype=dt), 51)}


def net_and_inputs(name, dtype=torch.bfloat16):
    model = random_weights(NETS[name][0](dtype), seed=1)
    g = torch.Generator().manual_seed(0)
    return model, torch.randn(1, 64, 128, 5, generator=g), torch.rand(1, 64, 128, 3, generator=g)


def forward(model, pcd, img):
    """The net's outputs, a tuple: both streams' probabilities (SalsaNext's one)."""
    return (model(pcd),) if isinstance(model, SalsaNext) else model(pcd, img)


@pytest.mark.parametrize("name", NETS)
def test_eval_forward_launches(monkeypatch, name):
    """With the gate as on the card an eval forward passes through the
    wrapper once a conv, the counts above; a second forward counts as many
    again. On the CPU the wrapper runs the twin and counts no launch."""
    card_gate(monkeypatch)
    rec = Recorder(monkeypatch)
    launches = rec.wrapper.launches
    model, pcd, img = net_and_inputs(name)
    with torch.inference_mode():
        forward(model, pcd, img)
    assert rec.calls == NETS[name][1]
    with torch.no_grad():
        forward(model, pcd, img)
    assert rec.calls == 2 * NETS[name][1]
    assert rec.wrapper.launches == launches


@pytest.mark.parametrize("name", NETS)
def test_fused_eval_matches_unfused(monkeypatch, name):
    """The nets' bf16 eval outputs with every epilogue in one pass (the twin)
    against PyTorch's chain: both streams' probabilities within 0.03 of each
    other and 1e-3 on average (measured: at most 0.0121 and 3.3e-4 over the
    three fusion nets, 7.9e-4 and 5.5e-5 for SalsaNext), each as close to the
    float32 net as the chain's (the mean gap at most 1.5x the chain's;
    measured 0.81-1.22x). Both round in bf16 at other places: the chain
    after the conv, its bias, BN's multiply and add, the residual, the twin
    once after the conv and once after its float32 epilogue; an ulp (2^-8
    relative) a conv compounds through some 40 convs. On the CPU the chain's conv adds its bias before rounding
    (cuDNN rounds first), so the chain is the closer one there by up to
    1.22x."""
    model, pcd, img = net_and_inputs(name)
    model32, _, _ = net_and_inputs(name, torch.float32)
    with torch.inference_mode():
        chain = forward(model, pcd, img)
        exact = forward(model32, pcd, img)
    card_gate(monkeypatch)
    with torch.inference_mode():
        fused = forward(model, pcd, img)
    for f, c, x in zip(fused, chain, exact):
        assert (f - c).abs().max() <= 0.03
        assert (f - c).abs().mean() <= 1e-3
        assert (f - x).abs().mean() <= 1.5 * (c - x).abs().mean()


def test_grad_float32_and_cpu_never_reach_the_wrapper(monkeypatch):
    """The CPU (the gate as it is) and, with the gate as on the card,
    float32, grad on, BN in train mode and a row split keep the chain: no
    forward reaches the wrapper."""
    rec = Recorder(monkeypatch)
    model, pcd, img = net_and_inputs("pmf_r34")
    with torch.inference_mode():
        model(pcd, img)
    assert rec.calls == 0
    card_gate(monkeypatch)
    model32, _, _ = net_and_inputs("pmf_r34", torch.float32)
    with torch.inference_mode():
        model32(pcd, img)
    model(pcd, img)   # grad on
    assert rec.calls == 0
    x = torch.randn(1, 8, 6, 6).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    conv, bn = L.Conv2d(8, 8, 3, padding=1), L.BatchNorm2d(8)
    with torch.no_grad():
        L.conv_block(x, conv, "leaky_relu", bn.train())
        L.conv_bn(x, conv, bn.train(), "relu")
    assert rec.calls == 0
    with torch.no_grad(), monkeypatch.context() as split:  # a row split, as `_fuses` reads it
        split.setattr(L.spatial, "active", lambda: "split")
        assert not L._fuses(x, None, bn.eval())
    with torch.no_grad():
        assert L._fuses(x, None, bn) and not L._fuses(x, x.contiguous(), bn)
    with torch.no_grad():
        L.conv_block(x, conv, "leaky_relu", bn.eval())
        L.conv_bn(x, conv, bn, "relu")
        L.conv_bn(x, conv, bn, residual=x, post="relu")
    assert rec.calls == 3


def test_cpu_tensors_count_no_launch():
    """On CPU tensors the wrapper runs the twin in place and leaves
    `launches` as it was: the counter counts the kernel's launches alone."""
    y, bias, act, bn, res, post = operands("leaky_relu_bn_residual", torch.bfloat16)
    a, b = bn.fold()
    want = E.conv_epilogue_plain(y.clone(), bias, act, a, b, res, post)
    before = E.conv_epilogue.launches
    got = E.conv_epilogue(y, bias, act, a, b, res, post)
    assert got is y and torch.equal(got, want) and E.conv_epilogue.launches == before


def bad_calls():
    """(name, y, kwargs) of calls the wrapper refuses."""
    c = 16
    y = torch.zeros(1, c, 4, 6, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bias = torch.zeros(c)
    yield "float32", y.float(), {"bias": bias}
    yield "nchw", y.contiguous(), {"bias": bias}
    yield "3d", y[0], {"bias": bias}
    yield "bias_bf16", y, {"bias": bias.to(torch.bfloat16)}
    yield "bias_short", y, {"bias": bias[:8]}
    yield "bias_none", y, {"bias": None}
    yield "a_without_b", y, {"bias": bias, "a": bias}
    yield "residual_nchw", y, {"bias": bias, "residual": y.contiguous()}
    yield "residual_shape", y, {"bias": bias, "residual": y[:, :8]}
    yield "residual_float32", y, {"bias": bias, "residual": y.float()}
    yield "act", y, {"bias": bias, "act": "gelu"}
    yield "post", y, {"bias": bias, "post": "sigmoid"}
    yield "no_kernel_relu_bn", y, {"bias": bias, "act": "relu", "a": bias, "b": bias}
    yield "no_kernel_sigmoid_residual", y, {"bias": bias, "act": "sigmoid", "residual": y}
    yield "no_kernel_bias_post", y, {"bias": bias, "post": "relu"}
    wide = torch.zeros(1, 2056, 2, 2, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    yield "too_wide", wide, {"bias": torch.zeros(2056)}
    odd = torch.zeros(1, 260, 2, 2, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    yield "too_wide_odd", odd, {"bias": torch.zeros(260)}


@pytest.mark.parametrize("name,y,kw", list(bad_calls()), ids=[n for n, _, _ in bad_calls()])
def test_wrapper_refuses(name, y, kw):
    """The wrapper raises on a y that is not bf16 [N, C, H, W] contiguous in
    channels_last or too wide, on vectors that are not float32 [C], on a
    residual not laid out as y, on an unknown activation or a variant no
    kernel was built for; it counts none."""
    before = E.conv_epilogue.launches
    with pytest.raises(ValueError):
        E.conv_epilogue(y, **kw)
    assert E.conv_epilogue.launches == before
