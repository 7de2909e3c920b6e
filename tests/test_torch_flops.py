"""The port's FLOP counter (`pmf_tpu_torch/utils/flops.py`) on the CPU:
against hand counts of one convolution, strided, grouped, a dense layer and
a bilinear resize, forward and train (forward + backward), and against
pmf_tpu's `count_flops` on the three nets' eval forwards (the port's on
`meta` tensors) and on the PMF train step, at the small shapes of
tests/test_torch_train.py."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from pmf_tpu import models as jmodels
from pmf_tpu import train as jtrain
from pmf_tpu.metrics import iou as jiou
from pmf_tpu.models.torch_convert import convert_generic_state_dict, convert_pmf_state_dict
from pmf_tpu.utils import flops as jflops
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch import train as ttrain
from pmf_tpu_torch.utils.flops import count_flops, mfu
from tests.test_torch_train import CFG, _aug, kitti_samples  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

# x [N, C, H, W], w [Cout, Cin/groups, kh, kw], stride, padding, groups, and
# the hand counts: 2 · out_elems · kh·kw·cin/groups forward; the input's
# gradient 2 · |x| · kh·kw·cout/groups (a conv over the stride-dilated
# output gradient: 4x the forward at stride 2); the weights' 2 · |w| ·
# N·Ho·Wo (torch's own rule counts the grouped one 4 times)
CONVS = {
    "conv": ((2, 3, 16, 20), (8, 3, 3, 3), 1, 1, 1, 276480, 276480, 276480),
    "strided": ((2, 4, 16, 20), (8, 4, 3, 3), 2, 1, 1, 92160, 368640, 92160),
    "grouped": ((1, 16, 8, 8), (16, 4, 3, 3), 1, 1, 4, 73728, 73728, 73728),
}


def _jax_conv(stride, padding, groups):
    return lambda x, w: lax.conv_general_dilated(
        x, w, (stride, stride), [(padding, padding)] * 2, feature_group_count=groups,
        dimension_numbers=("NCHW", "OIHW", "NCHW"))


@pytest.mark.parametrize("name", CONVS)
def test_conv_counts(name):
    xs, ws, stride, padding, groups, fwd, grad_x, grad_w = CONVS[name]
    x = torch.zeros(xs, requires_grad=True)
    w = torch.zeros(ws, requires_grad=True)
    conv = lambda: F.conv2d(x, w, stride=stride, padding=padding, groups=groups)
    assert count_flops(conv) == fwd
    assert count_flops(lambda: conv().sum().backward()) == fwd + grad_x + grad_w
    f = _jax_conv(stride, padding, groups)
    jx, jw = jnp.zeros(xs), jnp.zeros(ws)
    assert jflops.count_flops(f, jx, jw) == fwd
    assert jflops.count_flops(jax.grad(lambda a, b: f(a, b).sum(), (0, 1)), jx, jw) == \
        fwd + grad_x + grad_w


def test_dense_and_resize_counts():
    """x @ w + b: 2·M·N·K forward, 3x with the two gradients; the bilinear
    ×2 resize of [1, 2, 4, 6] (jax.image.resize's matmuls along W, then H:
    2·2·4·6·12 + 2·2·4·12·8), its backward the same again."""
    x = torch.zeros(8, 32, requires_grad=True)
    w = torch.zeros(32, 64, requires_grad=True)
    b = torch.zeros(64, requires_grad=True)
    dense = lambda: torch.addmm(b, x, w)
    assert count_flops(dense) == 32768 == 2 * 8 * 32 * 64
    assert count_flops(lambda: dense().sum().backward()) == 3 * 32768
    assert jflops.count_flops(lambda a, c, d: a @ c + d, x.detach().numpy(), w.detach().numpy(),
                              b.detach().numpy()) == 32768

    img = torch.zeros(1, 2, 4, 6, requires_grad=True)
    up = lambda: F.interpolate(img, scale_factor=2, mode="bilinear", align_corners=False)
    assert count_flops(up) == 2688
    with torch.inference_mode():
        assert count_flops(up) == 2688
    assert count_flops(lambda: up().sum().backward()) == 2 * 2688
    resize = lambda a: jax.image.resize(a, (1, 8, 12, 2), method="bilinear")
    assert jflops.count_flops(resize, jnp.zeros((1, 4, 6, 2))) == 2688
    assert jflops.count_flops(jax.grad(lambda a: resize(a).sum()), jnp.zeros((1, 4, 6, 2))) == \
        2 * 2688
    assert mfu(989e12 / 2) == 0.5


@pytest.mark.parametrize("net", ["PMFNet", "EPMFNet", "SalsaNext"])
def test_eval_forward_equals_pmf_tpu(net):
    """The eval forward of each net (base 8, 2 x 64 x 96; EPMFNet at 64 x 64,
    a multiple of 32) counted on `meta` tensors, equal to pmf_tpu's count
    of its own forward of the same weights."""
    model = tmodels.random_weights(getattr(tmodels, net)(nclasses=20, base_channels=8),
                                   seed=3).eval()
    convert = convert_generic_state_dict if net == "SalsaNext" else convert_pmf_state_dict
    params, stats = convert({k: v.numpy() for k, v in model.state_dict().items()})
    shape = (2, 64, 64 if net == "EPMFNet" else 96)
    inputs = [np.zeros(shape + (5,), np.float32)]
    if net != "SalsaNext":
        inputs.append(np.zeros(shape + (3,), np.float32))
    kw = {} if net == "SalsaNext" else {"train": False}
    jnet = getattr(jmodels, net)(nclasses=20, base_channels=8)
    want = jflops.count_flops(lambda v, *a: jnet.apply(v, *a, **kw),
                              {"params": params, "batch_stats": stats}, *map(jnp.asarray, inputs))
    on_meta = copy.deepcopy(model).to("meta")
    got = count_flops(on_meta, *(torch.from_numpy(a).to("meta") for a in inputs))
    assert got == want > 1e8


def test_pmf_train_step_equals_pmf_tpu_but_its_one_hot_scatters(kitti_samples):
    """The PMF train step (the train view of tests/test_torch_train.py, point
    Lovász, dropout 0) forward and backward, equal to pmf_tpu's count of
    its step but for two terms that pmf_tpu computes as one-hot matmuls and
    the port as scatters, which count nothing: the point Lovász's placement
    of the points' probabilities on the canvas
    (`pmf_tpu/ops/scatter.py: _place_pixel_sorted`) and the two confusion
    matrices (`pmf_tpu/metrics/iou.py: confusion_matrix`)."""
    f, _, label, points = tdata.build_batch(*map(torch.from_numpy, kitti_samples),
                                            tdata.PVConfig(**CFG), train=True,
                                            aug_override=_aug(), return_points=True)
    model = tmodels.random_weights(tmodels.PMFNet(nclasses=20, base_channels=8,
                                                  dropout_rate=0.0), seed=21)
    params, stats = convert_pmf_state_dict(
        {k: v.numpy().copy() for k, v in model.state_dict().items()})
    alpha = tuple([0.0] + [1.0] * 19)
    step = ttrain.make_pmf_train_step(model, ttrain.HybridOptimizer(model, lambda s: 1e-3, 0.9,
                                                                    1e-5),
                                      ttrain.LossConfig(alpha=alpha))
    got = count_flops(step, f, label, None, points)

    cfg = jtrain.LossConfig(alpha=alpha)
    jnet = jmodels.PMFNet(nclasses=20, base_channels=8, dropout_rate=0.0)
    tx = optax.sgd(1e-3)
    state = jtrain.TrainState.create({"params": params, "batch_stats": stats}, tx)
    feature, lab = jnp.asarray(f.numpy()), jnp.asarray(label.numpy())
    pts = tuple(jnp.asarray(p.numpy()) for p in points)
    want = jflops.count_flops(jtrain.make_pmf_train_step(jnet, tx, cfg, donate=False), state,
                              feature, lab, jax.random.PRNGKey(0), pts)
    probs = jnp.full(lab.shape + (20,), 0.05)
    placement = jflops.count_flops(
        lambda a, b: jtrain.steps.pmf_losses(a, b, lab, cfg, points=pts), probs, probs)
    confusion = jflops.count_flops(lambda p: jiou.confusion_matrix(p, lab, 20),
                                   jnp.zeros(lab.shape, jnp.int32))
    assert placement > 0 and confusion == 2 * 20 * 20 * lab.size
    assert got == want - placement - 2 * confusion
