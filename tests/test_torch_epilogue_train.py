"""The train-mode conv epilogue (`pmf_tpu_torch/ops/epilogue_train.py`) on
the CPU: its plain twin against PyTorch's chain of ops with a train-mode
`BatchNorm2d` in float64 (the output, the running statistics and the
gradients of y, the bias, γ, β and the residual), LeakyReLU's tie, one
rounding in bf16, remat, the gate, how many times a train forward takes it,
and a net's bf16 train step through it. The kernels themselves run only on
the card (tests/test_torch_cuda.py)."""
import pytest
import torch

from pmf_tpu_torch.models import EPMFNet, PMFNet, SalsaNext, random_weights
from pmf_tpu_torch.models import layers as L
from pmf_tpu_torch.ops import epilogue as E
from pmf_tpu_torch.ops import epilogue_train as T
from tests.torch_threads import one_torch_thread  # noqa: F401

# name: (family, act, residual, post, conv bias), each a call site of the nets
CASES = {
    "act_bn": ("act_bn", "leaky_relu", False, None, True),          # SalsaNext's blocks, decoders
    "act_bn_residual": ("act_bn", "leaky_relu", True, None, True),  # the blocks' last convs
    "bn_relu": ("bn_act", "relu", False, None, False),              # ResNet's stem, first convs
    "bn_relu_bias": ("bn_act", "relu", False, None, True),          # the fusion attention's first
    "bn_sigmoid_bias": ("bn_act", "sigmoid", False, None, True),    # and its second conv
    "bn": ("bn_act", None, False, None, False),                     # ResNet's downsamples
    "bn_residual_relu": ("bn_act", None, True, "relu", False),      # BasicBlock's last conv_bn
}


def operands(case, dtype, c=16, seed=0):
    """y [2, c, 5, 7] channels-last in `dtype` (its first pixel at y + bias =
    0: LeakyReLU's tie), the bias (or None), a residual (or None) and the
    output's gradient, in `dtype`; and a train-mode BN maker."""
    family, act, with_res, post, with_bias = CASES[case]
    g = torch.Generator().manual_seed(seed)
    cl = torch.channels_last
    y = (torch.randn(2, c, 5, 7, generator=g) * 2).to(dtype)
    bias = (torch.randn(c, generator=g) * 0.5).to(dtype) if with_bias else None
    if bias is not None:
        y[0, :, 0, 0] = -bias
    y = y.contiguous(memory_format=cl)
    res = torch.randn(y.shape, generator=g).to(dtype).contiguous(memory_format=cl) \
        if with_res else None
    gout = torch.randn(y.shape, generator=g).to(dtype)
    gamma, beta = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    mean0, var0 = torch.randn(c, generator=g) * 0.3, torch.rand(c, generator=g) + 0.5

    def make_bn(param_dtype=dtype):
        bn = L.BatchNorm2d(c).to(param_dtype).train()
        with torch.no_grad():
            for t, v in ((bn.weight, gamma), (bn.bias, beta), (bn.running_mean, mean0),
                         (bn.running_var, var0)):
                t.copy_(v)
        return bn
    return y, bias, res, gout, make_bn


def chain(y, bias, bn, family, act, res, post):
    """The epilogue as the modules run it: conv_block's BN(act(y + bias)) +
    residual, conv_bn's post(act(BN(y + bias)) + residual)."""
    t = y if bias is None else y + bias[:, None, None]
    if family == "act_bn":
        return L._chain(t, act, bn, res, post)
    return L._chain(bn(t), act, None, res, post)


def run(way, case, y, bias, res, gout, bn):
    """Forward and backward of `way` ("chain" or "twin"): {name: tensor}."""
    family, act, _, post, _ = CASES[case]
    y = y.clone().requires_grad_()
    bias = None if bias is None else bias.clone().requires_grad_()
    res = None if res is None else res.clone().requires_grad_()
    if way == "chain":
        out = chain(y, bias, bn, family, act, res, post)
    else:
        out = T.bn_epilogue_plain(y, bias, bn.weight, bn.bias, family, act, res, post,
                                  (bn.running_mean, bn.running_var), bn.eps, bn.momentum)
    out.backward(gout)
    got = {"out": out.detach(), "dy": y.grad, "dgamma": bn.weight.grad, "dbeta": bn.bias.grad,
           "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}
    if bias is not None:
        got["dbias"] = bias.grad
    if res is not None:
        got["dres"] = res.grad
    return got


@pytest.mark.parametrize("case", CASES)
def test_twin_equals_the_chain_in_float64(case):
    """In float64 the twin's output, running statistics and gradients (y,
    bias, γ, β, residual) are the chain's with a train-mode BatchNorm2d to
    1e-12 of their largest element. The twin takes the gradient through
    x̂ = (t − μ)/σ, the chain through E[t²] − E[t]²: equal but for rounding.
    conv_bn's bias feeds BN alone, so its gradient is nought but rounding:
    there it is held to 1e-12 of Σ|dy|, the size of the sum's terms."""
    y, bias, res, gout, make_bn = operands(case, torch.float64)
    want = run("chain", case, y, bias, res, gout, make_bn())
    got = run("twin", case, y, bias, res, gout, make_bn())
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = w.abs().max()
        if k == "dbias" and CASES[case][0] == "bn_act":
            scale = want["dy"].abs().sum(dim=(0, 2, 3)).max()
        assert (got[k] - w).abs().max() <= 1e-12 * scale, k
    assert not torch.equal(want["running_mean"], make_bn().running_mean)


@pytest.mark.parametrize("case", ["act_bn", "act_bn_residual"])
def test_leaky_relu_tie_takes_0505(case):
    """Where y + bias is exactly 0, LeakyReLU's subgradient is 0.505, as
    torch.maximum(x, 0.01x) splits a tie: dy there is 0.505 times the
    gradient of BN's input (1 as F.leaky_relu would give it, or 0.01, would
    not match)."""
    y, bias, res, gout, make_bn = operands(case, torch.float64)
    got = run("twin", case, y, bias, res, gout, make_bn())
    t = L.leaky_relu(y + bias[:, None, None]).requires_grad_()
    make_bn()(t).backward(gout)
    tie = (y + bias[:, None, None]) == 0
    assert tie.sum() == y.shape[1]
    assert torch.allclose(got["dy"][tie], 0.505 * t.grad[tie], rtol=1e-12, atol=0)
    assert (t.grad[tie].abs() > 1e-6).all()


@pytest.mark.parametrize("case", CASES)
def test_twin_rounds_once_in_bf16(case):
    """On bf16 y the twin computes in float32 from y, the bias and the
    residual as they are and rounds once: within one bf16 ulp of the float32
    chain on the same values cast to bf16 (the two take σ's reciprocal
    square root by different ops), in y's layout; its running statistics
    within 1e-6 of the chain's."""
    y, bias, res, gout, make_bn = operands(case, torch.bfloat16)
    family, act, _, post, _ = CASES[case]
    bn32 = make_bn(torch.float32)
    want = chain(y.float(), None if bias is None else bias.float(), bn32, family, act,
                 None if res is None else res.float(), post).to(torch.bfloat16)
    bn = make_bn(torch.float32)
    with torch.no_grad():
        got = T.bn_epilogue_plain(y, None if bias is None else bias.float(), bn.weight, bn.bias,
                                  family, act, res, post, (bn.running_mean, bn.running_var))
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - 7)
    assert ((got.float() - want.float()).abs() <= ulp).all()
    assert torch.allclose(bn.running_mean, bn32.running_mean, rtol=0, atol=1e-6)
    assert torch.allclose(bn.running_var, bn32.running_var, rtol=0, atol=1e-6)


def card_gate(monkeypatch):
    """The gates as on the card, less their CUDA test: a bf16 4-d tensor
    contiguous in channels_last. The wrapper then runs the twin (the CPU
    path)."""
    monkeypatch.setattr(E, "epilogue_takes", lambda t: (
        t.dtype == torch.bfloat16 and t.dim() == 4
        and t.is_contiguous(memory_format=torch.channels_last)))


class Recorder:
    """Stands in for `bn_epilogue` where the nets call it: counts the calls
    and passes each on to the wrapper (on CPU tensors, the twin)."""

    def __init__(self, monkeypatch):
        self.calls, self.wrapper = 0, T.bn_epilogue
        monkeypatch.setattr(L.epilogue_train, "bn_epilogue", self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.wrapper(*args, **kwargs)


class Pair(torch.nn.Module):
    """A conv_block with BN (act_bn) and a conv_bn with a residual and a
    closing relu (bn_act), on 16 channels."""

    def __init__(self):
        super().__init__()
        self.c1, self.b1 = L.Conv2d(16, 16, 3, padding=1), L.BatchNorm2d(16)
        self.c2, self.b2 = L.Conv2d(16, 16, 3, padding=1, bias=False), L.BatchNorm2d(16)

    def forward(self, x):
        h = L.conv_block(x, self.c1, "leaky_relu", self.b1)
        return L.conv_bn(h, self.c2, self.b2, residual=x, post="relu")


def pair_and_input(seed=0):
    torch.manual_seed(seed)
    m = Pair()
    x = torch.randn(2, 16, 6, 8).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return m.train(), x


def test_remat_moves_the_running_statistics_once(monkeypatch):
    """Under remat the stage's forward runs twice (its recompute in the
    backward pass) through the wrapper, and the running statistics move
    once: equal to the run without remat, as are the output and every
    gradient."""
    card_gate(monkeypatch)
    rec = Recorder(monkeypatch)
    results = []
    for remat in (False, True):
        m, x = pair_and_input()
        x.requires_grad_()
        rec.calls = 0
        out = L.remat_stage(remat, m, x)
        out.float().square().sum().backward()
        results.append((rec.calls, out.detach(), x.grad,
                        {k: v.clone() for k, v in m.state_dict().items()},
                        {k: p.grad for k, p in m.named_parameters()}))
    (n0, out0, dx0, sd0, g0), (n1, out1, dx1, sd1, g1) = results
    assert (n0, n1) == (2, 4)
    assert torch.equal(out0, out1) and torch.equal(dx0, dx1)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    m, _ = pair_and_input()
    assert not torch.equal(sd0["b1.running_mean"], m.b1.running_mean)


def gate_call(case):
    """(x, residual, bn, family, act, post) for `_fuses_train`: a case it
    refuses, or "takes"."""
    cl = torch.channels_last
    x = torch.randn(1, 16, 4, 6).to(torch.bfloat16).contiguous(memory_format=cl)
    bn = L.BatchNorm2d(16).train()
    call = dict(x=x, residual=None, bn=bn, family="act_bn", act="leaky_relu", post=None)
    if case == "float32":
        call["x"] = x.float()
    elif case == "nchw":
        call["x"] = x.contiguous()
    elif case == "residual_nchw":
        call.update(residual=x.contiguous(), family="bn_act", act=None, post="relu")
    elif case == "eval_bn":
        bn.eval()
    elif case == "width":
        call.update(x=torch.randn(1, 12, 4, 6).to(torch.bfloat16).contiguous(memory_format=cl),
                    bn=L.BatchNorm2d(12).train())
    elif case == "variant":
        call["act"] = "relu"
    return call


@pytest.mark.parametrize("case", ["takes", "float32", "nchw", "residual_nchw", "eval_bn",
                                  "width", "variant", "grad_off", "split", "process_group"])
def test_gate(monkeypatch, case):
    """With the tensor test as on the card, `_fuses_train` takes a bf16
    channels-last conv input with grad on and BN in train mode, and refuses
    float32, NCHW (x or the residual), BN in eval mode, a width or a variant
    the kernels do not hold, grad off, an active row split and a process
    group (whose sums would need an all-reduce)."""
    card_gate(monkeypatch)
    call = gate_call(case)
    if case == "split":
        monkeypatch.setattr(L.spatial, "active", lambda: "split")
    if case == "process_group":
        monkeypatch.setattr(L, "data_parallel", lambda: True)
    with torch.set_grad_enabled(case != "grad_off"):
        assert L._fuses_train(**call) == (case == "takes")


# one bn_epilogue a train-mode BN that the nets reach through conv_block and
# conv_bn, with the maps channels-last: PMF-ResNet34 94 (ResNet34 36, the
# lidar stream 54, the RGB decoder 4); EPMF-ResNet34 86 of its 96 (its six
# float32 sparse-context BNs call `bn` itself, and the camera decoder's four
# stages follow ASPP's 512-channel branches, taken in NCHW); PMF-ResNet50 111
# (ResNet50 53); SalsaNext 42
TRAIN_NETS = {
    "pmf_r34": (lambda dt: PMFNet(nclasses=20, base_channels=8, image_backbone="resnet34",
                                  dtype=dt), 94),
    "epmf_r34": (lambda dt: EPMFNet(nclasses=20, base_channels=8, image_backbone="resnet34",
                                    dtype=dt), 86),
    "pmf_r50": (lambda dt: PMFNet(nclasses=20, base_channels=8, image_backbone="resnet50",
                                  dtype=dt), 111),
    "salsanext": (lambda dt: SalsaNext(nclasses=20, base_channels=8, dtype=dt), 42),
}


def train_net(name, dtype=torch.bfloat16):
    model = random_weights(TRAIN_NETS[name][0](dtype), seed=1).train()
    g = torch.Generator().manual_seed(0)
    return model, torch.randn(1, 64, 128, 5, generator=g), torch.rand(1, 64, 128, 3, generator=g)


def train_forward(model, pcd, img, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = model(pcd, g) if isinstance(model, SalsaNext) else model(pcd, img, g)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", TRAIN_NETS)
def test_train_forward_calls(monkeypatch, name):
    """With the gate as on the card a bf16 train forward passes each BN the
    nets reach through conv_block and conv_bn through the wrapper once (the
    counts above); a float32 train forward and a bf16 eval forward none. On
    the CPU the wrapper runs the twin and counts no launch."""
    card_gate(monkeypatch)
    rec = Recorder(monkeypatch)
    launches = rec.wrapper.launches
    model, pcd, img = train_net(name)
    train_forward(model, pcd, img)
    assert rec.calls == TRAIN_NETS[name][1]
    with torch.no_grad():
        model.eval()
        train_forward(model, pcd, img)
    model32, _, _ = train_net(name, torch.float32)
    train_forward(model32, pcd, img)
    assert rec.calls == TRAIN_NETS[name][1]
    assert rec.wrapper.launches == launches


def leaf_gaps(got: dict, want: dict) -> list:
    """Each leaf's |‖g‖ − ‖w‖| over the larger of ‖w‖ and the median leaf's
    norm (the benchmark's train limit's measure)."""
    norms = {k: w.float().norm() for k, w in want.items()}
    median = torch.stack(list(norms.values())).median()
    return sorted(((got[k].float().norm() - n).abs() / torch.maximum(n, median)).item()
                  for k, n in norms.items())


def test_fused_train_step_is_as_close_to_float32(monkeypatch):
    """One bf16 PMF-ResNet34 train step (forward, a loss, backward) with
    every BN through the twin is as close to the float32 step as PyTorch's
    bf16 chain is: the mean gap of both streams' probabilities, the median
    leaf's gradient-norm gap and the largest gap of the running statistics
    each at most 1.5x the chain's (measured 0.85x and 0.76x, 1.09x, 0.83x).
    At this size (one 64x128 scan, base 8; ResNet's layer4 holds 32 pixels
    a channel) a bf16 train step parts from float32 by tenths in a few
    probabilities and by 3 % in the median leaf either way; the twin rounds
    once a pass, the chain after the conv's bias, BN's multiply and add and
    the residual, and at each op of its backward."""
    runs = {}
    for mode in ("float32", "chain", "fused"):
        with monkeypatch.context() as mp:
            if mode == "fused":
                card_gate(mp)
            model, pcd, img = train_net("pmf_r34", torch.float32 if mode == "float32"
                                        else torch.bfloat16)
            out = train_forward(model, pcd, img)
            sum(o.float().square().mean() for o in out).backward()
            runs[mode] = ([o.detach().float() for o in out],
                          {k: p.grad for k, p in model.named_parameters()},
                          {k: v for k, v in model.state_dict().items() if "running" in k})
    (out32, g32, s32) = runs["float32"]

    def gaps(mode):
        out, grads, stats = runs[mode]
        leaves = leaf_gaps(grads, g32)
        return ([(o - x).abs().mean() for o, x in zip(out, out32)], leaves[len(leaves) // 2],
                max((stats[k] - s32[k]).abs().max() for k in s32))
    (out_c, leaf_c, stat_c), (out_f, leaf_f, stat_f) = gaps("chain"), gaps("fused")
    assert all(f <= 1.5 * c for f, c in zip(out_f, out_c))
    assert leaf_f <= 1.5 * leaf_c and stat_f <= 1.5 * stat_c


def test_cpu_tensors_count_no_launch():
    """On CPU tensors the wrapper runs the twin and leaves `launches` as it
    was: the counter counts the kernels' calls alone."""
    y, bias, res, gout, make_bn = operands("act_bn_residual", torch.bfloat16)
    bn = make_bn(torch.float32)
    before = T.bn_epilogue.launches
    out = T.bn_epilogue(y, bias.float(), bn.weight, bn.bias, "act_bn", "leaky_relu", res)
    want = T.bn_epilogue_plain(y, bias.float(), bn.weight, bn.bias, "act_bn", "leaky_relu", res)
    assert torch.equal(out, want) and T.bn_epilogue.launches == before


@pytest.mark.parametrize("kw", [{"family": "bn"}, {"act": "gelu"}, {"post": "sigmoid"}],
                         ids=["family", "act", "post"])
def test_wrapper_refuses_unknown_names(kw):
    """An unknown family, activation or closing op raises before any pass."""
    y, bias, _, _, make_bn = operands("act_bn", torch.float32)
    bn = make_bn()
    call = {"family": "act_bn", "act": "leaky_relu", "post": None, **kw}
    with pytest.raises(ValueError):
        T.bn_epilogue(y, bias, bn.weight, bn.bias, **call)


def test_pixel_rows():
    """The backward takes g as it is where its pixels are rows of C at one
    stride, 16-byte aligned: a channels-last tensor (stride C) and a channel
    slice of one at a multiple of 8 channels (the gradient of a
    concatenation's part: the whole's width); else a channels-last copy."""
    cl = torch.channels_last
    whole = torch.randn(2, 48, 5, 7).to(torch.bfloat16).contiguous(memory_format=cl)
    g, ld = T._pixel_rows(whole)
    assert g is whole and ld == 48
    part = whole[:, 16:32]
    g, ld = T._pixel_rows(part)
    assert g is part and ld == 48
    for other in (whole.contiguous(), whole[:, 4:20], whole[:, :, 1:]):
        g, ld = T._pixel_rows(other)
        assert g is not other and ld == other.shape[1] and torch.equal(g, other)
        assert g.is_contiguous(memory_format=cl)
