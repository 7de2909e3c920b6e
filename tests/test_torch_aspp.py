"""ASPP's branch kernel (`pmf_tpu_torch/ops/aspp.py`) on the CPU: the live-tap
plan that the wrapper hands the kernel, the plain branches written into the
concat buffer, and when `ASPP.forward` takes the kernel. The kernel itself
runs only on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pmf_tpu_torch.models import pmf as pmf_models
from pmf_tpu_torch.ops import aspp as A
from pmf_tpu_torch.parallel import spatial
from tests.torch_threads import one_torch_thread  # noqa: F401

DIL = (6, 12, 18)


def int_operands(nb, c, h, w, seed, dtype=torch.float64):
    """Small integers: every sum of products is exact in float64, so any
    order of summation gives the same bits."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-3, 4, (nb, c, h, w), generator=g).to(dtype)
    ws = [torch.randint(-2, 3, (c, c, 1, 1), generator=g).to(dtype)] + [
        torch.randint(-2, 3, (c, c, 3, 3), generator=g).to(dtype) for _ in DIL]
    bs = [torch.randint(-4, 5, (c,), generator=g).to(dtype) for _ in range(4)]
    return x, ws, bs


def apply_plan(x: torch.Tensor, weights, biases, dilations, plan: np.ndarray,
               bm: int, bn: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, tile by tile as `plan`
    gives it: x NCHW → the four branches, NHWC [N, H, W, 4C], in x's dtype.
    Out-of-map reads of a live tap are zeros; dead taps are skipped."""
    nb, c, h, w = x.shape
    m = nb * h * w
    xh = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))  # one zero pixel around
    n, y, xx = (torch.arange(m) // (h * w)), (torch.arange(m) // w) % h, torch.arange(m) % w
    out = x.new_zeros((m, 4 * c))
    for tile, branch, nt, mask in plan.tolist():
        pix = torch.arange(tile * bm, min(tile * bm + bm, m))
        acc = x.new_zeros((len(pix), bn))
        kernel = weights[branch].to(x.dtype)
        for t, (dy, dx) in zip([4] if branch == 0 else range(9), A.tap_offsets(branch, dilations)):
            if not mask >> t & 1:
                continue
            sy, sx = y[pix] + dy, xx[pix] + dx
            inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
            # out-of-map reads land on the zero border
            src = xh[n[pix], torch.where(inside, sy + 1, 0), torch.where(inside, sx + 1, 0)]
            wt = kernel[nt * bn:(nt + 1) * bn, :, t // 3 if branch else 0, t % 3 if branch else 0]
            acc += src @ wt.T
        acc += biases[branch][nt * bn:(nt + 1) * bn].to(x.dtype)
        out[pix, branch * c + nt * bn:branch * c + (nt + 1) * bn] = acc
    return out.reshape(nb, h, w, 4 * c)


# (N, H, W, pixels a tile): the EPMF camera map, PMF's and EPMF's lidar heads,
# PMF's head at batch 1, and a tile of 48 pixels that straddles rows unevenly
SHAPES = [(2, 20, 80, 128), (2, 24, 77, 128), (2, 10, 40, 128), (1, 24, 77, 128),
          (1, 20, 80, 48)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("branch", [0, 1, 2, 3], ids=["1x1", "d6", "d12", "d18"])
def test_plan_is_the_padded_conv(shape, branch):
    """Each branch computed tile by tile over the plan's live taps alone,
    out-of-map reads zero, equals F.conv2d with zero padding exactly; and
    for the dilated branches the plan does skip taps (a tile whose every
    read of a tap lies in the padding)."""
    nb, h, w, bm = shape
    c = 8
    x, ws, bs = int_operands(nb, c, h, w, seed=h * w + branch)
    plan = A.aspp_plan(nb, h, w, c, DIL, bm, bn=c)
    got = apply_plan(x, ws, bs, DIL, plan[plan[:, 1] == branch], bm, c)
    d = DIL[branch - 1] if branch else 1
    want = F.conv2d(x, ws[branch], bs[branch], padding=d if branch else 0, dilation=d)
    assert torch.equal(got[..., c * branch:c * (branch + 1)], want.permute(0, 2, 3, 1))
    masks = plan[plan[:, 1] == branch, 3]
    # every tap that reads the map somewhere is live in some tile
    reach = [t for t, (dy, dx) in zip([4] if branch == 0 else range(9), A.tap_offsets(branch, DIL))
             if max(0, -dy) < min(h, h - dy) and max(0, -dx) < min(w, w - dx)]
    assert int(np.bitwise_or.reduce(masks)) == sum(1 << t for t in reach)
    if branch >= 2:
        assert min(bin(int(v)).count("1") for v in masks) < 9


@pytest.mark.parametrize("shape,bn", [((8, 20, 80, 512), 256), ((8, 24, 77, 256), 256),
                                      ((8, 10, 40, 256), 128), ((1, 24, 77, 256), 128)])
def test_plan_covers_each_tile_once_heavy_first(shape, bn):
    """At the four shapes of the nets: the tile width the wrapper picks on
    an H100, each (tile, branch, channel tile) once, most live taps first."""
    nb, h, w, c = shape
    assert A.tile_n(nb * h * w, c, sms=132) == bn  # an H100's multiprocessors
    plan = A.aspp_plan(nb, h, w, c, DIL, A.BM, bn)
    tiles = -(-nb * h * w // A.BM)
    keys = {tuple(r) for r in plan[:, :3].tolist()}
    assert len(keys) == len(plan) == tiles * 4 * (c // bn)
    live = [bin(int(v)).count("1") for v in plan[:, 3]]
    assert live == sorted(live, reverse=True)
    # the tiles' products: the live FLOPs plus what zero fill adds inside live taps
    assert sum(live) * 2 * A.BM * bn * c >= A.live_flops(nb, h, w, c, DIL)


def test_live_flops_counts_in_map_taps():
    """On a map of 20 rows a dilation-18 row tap reaches 2 rows: the count is
    below the nominal 28 taps and equal to a brute-force count."""
    nb, h, w, c = 1, 20, 80, 4
    brute = 0
    for b in range(4):
        for dy, dx in A.tap_offsets(b, DIL):
            brute += sum(0 <= yy + dy < h and 0 <= xx + dx < w
                         for yy in range(h) for xx in range(w))
    assert A.live_flops(nb, h, w, c, DIL) == 2 * c * c * brute < 2 * c * c * h * w * 28


def aspp_module(c, seed):
    m = pmf_models.ASPP(c, c).double().eval()
    _, ws, bs = int_operands(1, c, 1, 1, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for conv, wt, b in zip((m.atrous_block1, m.atrous_block6, m.atrous_block12,
                                m.atrous_block18), ws, bs):
            conv.weight.copy_(wt)
            conv.bias.copy_(b)
        for conv in (m.conv, m.conv_1x1_output):
            conv.weight.copy_(torch.randint(-2, 3, conv.weight.shape, generator=g))
            conv.bias.copy_(torch.randint(-2, 3, conv.bias.shape, generator=g))
    return m


def buffer_forward(m, x):
    """The kernel path's arithmetic with the plain branches: the pooled
    branch broadcast into slice [0, C) of the NHWC buffer, the four branches
    into theirs, conv_1x1_output on the buffer."""
    n, c, h, w = x.shape
    cat = x.new_empty((n, h, w, 5 * c))
    cat[..., :c] = m.conv(spatial.spatial_mean(x)).view(n, 1, 1, c)
    branches = (m.atrous_block1, m.atrous_block6, m.atrous_block12, m.atrous_block18)
    A.aspp_branches(x, [b.weight for b in branches], [b.bias for b in branches], DIL, cat)
    return m.conv_1x1_output(cat.permute(0, 3, 1, 2))


@pytest.mark.parametrize("shape", [(2, 8, 16), (1, 20, 32)])
def test_plain_buffer_then_1x1_equals_forward(shape):
    """`aspp_branches` (its plain version on the CPU) into the concat buffer
    followed by conv_1x1_output equals ASPP.forward's conv-and-cat path,
    bit for bit (integers, and H·W a power of two so the pooled mean is
    exact)."""
    n, h, w = shape
    c = 16
    m = aspp_module(c, seed=3)
    x, _, _ = int_operands(n, c, h, w, seed=4)
    with torch.inference_mode():
        want = m(x)
        got = buffer_forward(m, x)
    assert got.shape == want.shape == (n, c, h, w)
    assert torch.equal(got, want)


class Recorder:
    def __init__(self):
        self.calls, self.dilations = 0, None

    def __call__(self, x, weights, biases, dilations, out):
        self.calls += 1
        self.dilations = dilations
        return A.aspp_branches_plain(x, weights, biases, dilations, out)


class SplitInForce:
    """`parallel.spatial` as ASPP.forward reads it while a row split is in
    force (one rank: the pooled mean is the plain one)."""
    active = staticmethod(lambda: "split")
    spatial_mean = staticmethod(lambda x: x.mean(dim=(2, 3), keepdim=True))


def test_forward_takes_the_kernel_only_in_inference(monkeypatch):
    """ASPP.forward launches the kernel only on a tensor the kernel takes,
    with grad off and no row split. On the CPU it never does; with the
    card's test (`aspp_takes`) made true, grad on or a split in force still
    keeps the convs, and inference_mode or no_grad take the kernel."""
    rec = Recorder()
    monkeypatch.setattr(pmf_models, "aspp_branches", rec)
    m = aspp_module(16, seed=5)
    x, _, _ = int_operands(1, 16, 8, 16, seed=6)
    with torch.inference_mode():
        want = m(x)
    m(x)
    assert rec.calls == 0  # the CPU: neither in inference nor with grad

    monkeypatch.setattr(pmf_models, "aspp_takes", lambda t: True)
    m(x).sum().backward()
    assert rec.calls == 0
    with monkeypatch.context() as split:  # a row split in force, as ASPP.forward sees it
        split.setattr(pmf_models, "spatial", SplitInForce)
        with torch.no_grad():
            m(x)
    assert rec.calls == 0
    with torch.inference_mode():
        got = m(x)
    with torch.no_grad():
        m(x)
    assert rec.calls == 2
    assert rec.dilations == (6, 12, 18)  # read off the modules
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,nchw", [(512, True), (256, False)])
def test_conv_path_runs_wide_dilated_convs_on_nchw(c, nchw):
    """On the conv path (grad on) channels-last x reaches the three dilated
    convs as an NCHW copy where C is 512 or more (channels-last sends
    cuDNN's to its direct kernel there) and as it is below; the 1x1 branch
    takes x as it is. The output is that of NCHW x."""
    m = pmf_models.ASPP(c, c)
    x = torch.randn(1, c, 3, 4).contiguous(memory_format=torch.channels_last)
    names = ("atrous_block1", "atrous_block6", "atrous_block12", "atrous_block18")
    nchw_in = {}
    for name in names:
        getattr(m, name).register_forward_pre_hook(
            lambda mod, args, name=name: nchw_in.__setitem__(name, args[0].is_contiguous()))
    y = m(x)
    assert nchw_in == dict(zip(names, (False, nchw, nchw, nchw)))
    with torch.no_grad():
        assert torch.allclose(y, m(x.contiguous()), rtol=1e-5, atol=1e-6)


def test_kernel_refuses_what_it_does_not_take():
    """Off the CPU the wrapper launches or raises: float32, C not a
    multiple of 128, branches whose out channels are not C, or a dilated
    branch that is not 3x3, are refused before any launch (meta tensors)."""
    out = torch.empty((1, 4, 4, 5 * 64), dtype=torch.bfloat16, device="meta")
    ws = [torch.empty(64, 64, k, k, device="meta") for k in (1, 3, 3, 3)]
    bs = [torch.empty(64, device="meta")] * 4
    with pytest.raises(ValueError):
        A.aspp_branches(torch.empty((1, 64, 4, 4), dtype=torch.bfloat16, device="meta"),
                        ws, bs, DIL, out)
    with pytest.raises(ValueError):
        A.aspp_branches(torch.empty((1, 128, 4, 4), device="meta"), ws, bs, DIL,
                        out.new_empty((1, 4, 4, 640)))
    with pytest.raises(ValueError):  # C = 128 in, 64 out
        A.aspp_branches(torch.empty((1, 128, 4, 4), dtype=torch.bfloat16, device="meta"),
                        [w.new_empty((64, 128) + w.shape[2:]) for w in ws], bs, DIL,
                        out.new_empty((1, 4, 4, 640)))
    with pytest.raises(ValueError):  # a 5x5 kernel where the kernel takes 3x3
        A.aspp_branches(torch.empty((1, 128, 4, 4), dtype=torch.bfloat16, device="meta"),
                        [w.new_empty((128, 128) + w.shape[2:]) for w in ws[:3]]
                        + [ws[3].new_empty((128, 128, 5, 5))], bs, DIL,
                        out.new_empty((1, 4, 4, 640)))
    assert A.aspp_branches.launches == 0
