"""The rest of pmf_tpu in the port, each held to pmf_tpu on the CPU on the
same seeded numpy inputs: the smoothness and smooth-L1 losses, the
exported layers, the accuracy metrics, `iou_from_confusion`, the other
learning-rate schedules, `perception_aware_loss`, the `KNN` re-export and
`tools/create_fov_dataset.py`."""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu import losses as jlosses
from pmf_tpu import postproc as jpostproc
from pmf_tpu.losses import smoothness as jsmooth
from pmf_tpu.losses.weighted_smoothl1 import weighted_smooth_l1 as jsmooth_l1
from pmf_tpu.metrics import acc as jacc
from pmf_tpu.metrics import iou as jiou
from pmf_tpu.models import modules as jmodules
from pmf_tpu.tools.create_fov_dataset import create_fov_dataset as jcreate_fov
from pmf_tpu.train import schedules as jsched
from pmf_tpu_torch import losses as tlosses
from pmf_tpu_torch import metrics as tmetrics
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch import postproc as tpostproc
from pmf_tpu_torch.tools.create_fov_dataset import create_fov_dataset
from pmf_tpu_torch.train import schedules as tsched
from tests.test_data_pipeline import kitti_root  # noqa: F401 (a fixture)
from tests.test_torch_models import random_flax_tree


def _nhwc(seed, shape=(2, 8, 10, 3), scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_()


@pytest.mark.parametrize("case", ["smoothness", "smoothness_map", "grad_guide"])
def test_smoothness_losses_match_jax(case):
    """Values and gradients to 1e-5 (the port on NCHW, pmf_tpu on NHWC)."""
    x, t = _nhwc(0), _nhwc(1)
    if case == "smoothness":
        jf = lambda a: jsmooth.smoothness_loss(a)
        tf = lambda a: tlosses.smoothness_loss(a)
    elif case == "smoothness_map":
        w = _nhwc(2)
        jf = lambda a: (jsmooth.smoothness_loss(a, size_average=False) * w).sum()
        tf = lambda a: (tlosses.smoothness_loss(a, size_average=False)
                        * torch.from_numpy(w).permute(0, 3, 1, 2)).sum()
    else:
        jf = lambda a: jsmooth.grad_guide_loss(a, jnp.asarray(t))
        tf = lambda a: tlosses.grad_guide_loss(a, torch.from_numpy(t).permute(0, 3, 1, 2))
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(x))
    xt = _nchw(x)
    got = tf(xt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("weight,mask,sigma", [(False, False, 3.0), (True, False, 3.0),
                                               (False, True, 1.0), (True, True, 3.0)])
def test_weighted_smooth_l1_matches_jax(weight, mask, sigma):
    """Both branches of the Huber loss (|d| < 1/sigma² and past it), with and
    without a weight and a broadcast mask: values and gradients to 1e-6."""
    x, t = _nhwc(3, scale=0.3), _nhwc(4, scale=0.3)
    w = np.random.default_rng(5).random(x.shape).astype(np.float32) if weight else None
    m = (np.random.default_rng(6).random(x.shape[:3] + (1,)) > 0.4) if mask else None
    want, want_g = jax.value_and_grad(lambda a: jsmooth_l1(
        a, jnp.asarray(t), sigma, None if w is None else jnp.asarray(w),
        None if m is None else jnp.asarray(m)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tlosses.weighted_smooth_l1(xt, torch.from_numpy(t), sigma,
                                     None if w is None else torch.from_numpy(w),
                                     None if m is None else torch.from_numpy(m))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-9)
    d = np.abs(x - t)
    assert (d < 1 / sigma ** 2).any() and (d >= 1 / sigma ** 2).any()


@pytest.mark.parametrize("name,train", [("ConvUpSample", False), ("ConvUpSample", True),
                                        ("CSAttention", False)])
def test_exported_layers_match_flax(name, train):
    """ConvUpSample (eval, and train with batch statistics) and CSAttention
    with random flax trees crossed by models/convert.py: features to 1e-6."""
    x = _nhwc(7, (2, 6, 8, 4))
    flax_model = getattr(jmodules, name)(features=5)
    shapes = jax.eval_shape(lambda: flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = random_flax_tree(shapes["params"], 8)
    stats = random_flax_tree(shapes.get("batch_stats", {}), 9)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    port = getattr(tmodels, name)(4, 5)
    port.load_state_dict(tmodels.state_dict_from_flax(port, params, stats))
    if train:
        want, _ = flax_model.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        port.train()
    else:
        want = flax_model.apply(variables, jnp.asarray(x))
        port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_metrics_match_jax(k):
    """topk_accuracy and AccEval over three batches, exactly."""
    rng = np.random.default_rng(10 + k)
    batches = [(rng.normal(size=(n, 6, 10)).astype(np.float32), rng.integers(0, 10, (n, 6)))
               for n in (3, 5, 2)]
    logits, target = batches[0]
    assert float(tmetrics.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(target), k)) \
        == float(jacc.topk_accuracy(jnp.asarray(logits), jnp.asarray(target), k))
    got, want = tmetrics.AccEval(k), jacc.AccEval(k)
    for logits, target in batches:
        got.addBatch(torch.from_numpy(logits), target)
        want.addBatch(logits, target)
    assert got.getAcc() == want.getAcc() and 0 < got.getAcc() < 1


@pytest.mark.parametrize("ignore", [(), (0,), (0, 7)])
def test_iou_from_confusion_matches_jax(ignore):
    conf = np.random.default_rng(12).integers(0, 50, (20, 20)).astype(np.float32)
    conf[5] = conf[:, 5] = 0            # a class never seen nor predicted
    miou, iou = tmetrics.iou_from_confusion(conf, ignore)
    jmiou, jiou_c = jiou.iou_from_confusion(conf, ignore)
    assert miou == jmiou
    np.testing.assert_array_equal(iou, jiou_c)


@pytest.mark.parametrize("name", ["warmup_exp_lr", "warmup_multistep_lr", "clip_lr"])
def test_schedules_match_jax(name):
    """Steps 0…300 to 1e-7 of pmf_tpu's float32 values."""
    make = {"warmup_exp_lr": lambda m: m.warmup_exp_lr(1e-2, 50, 0.99),
            "warmup_multistep_lr": lambda m: m.warmup_multistep_lr(1e-2, 50, [200, 100], 0.1),
            "clip_lr": lambda m: m.clip_lr(m.warmup_exp_lr(1e-2, 50, 0.99), 2e-3)}[name]
    got, want = make(tsched), make(jsched)
    steps = range(301)
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=0, atol=1e-7)


def test_perception_aware_loss_matches_jax():
    """The loss and both guide weights to 1e-5, and its gradient."""
    rng = np.random.default_rng(13)
    logits = rng.normal(size=(2, 2, 6, 8, 20)) * rng.uniform(0.5, 8.0, (2, 2, 6, 8, 1))
    pcd, img = (np.exp(z) / np.exp(z).sum(-1, keepdims=True) for z in logits.astype(np.float32))
    want, wp, wi = jlosses.perception_aware_loss(jnp.asarray(pcd), jnp.asarray(img))
    want_g = jax.grad(lambda a, b: jlosses.perception_aware_loss(a, b)[0], argnums=(0, 1))(
        jnp.asarray(pcd), jnp.asarray(img))
    tp, ti = (torch.from_numpy(a).requires_grad_() for a in (pcd, img))
    got, gp, gi = tlosses.perception_aware_loss(tp, ti)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for a, b in ((gp, wp), (gi, wi), (tp.grad, want_g[0]), (ti.grad, want_g[1])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert (wp > 0).any() and (wi > 0).any()


def test_knn_reexport_matches_jax():
    """postproc.KNN is the port's knn_postprocess and votes as pmf_tpu's
    postproc.KNN does."""
    assert tpostproc.KNN is tpostproc.knn_postprocess
    np.testing.assert_array_equal(tpostproc.gaussian_kernel2d(5, 1.0),
                                  jpostproc.gaussian_kernel2d(5, 1.0))
    rng = np.random.default_rng(14)
    H, W, P = 10, 16, 200
    proj_range = rng.uniform(1, 30, (H, W)).astype(np.float32)
    proj_range[rng.random((H, W)) < 0.3] = -1.0
    argmax = rng.integers(0, 20, (H, W)).astype(np.int32)
    py, px = rng.integers(0, H, P).astype(np.int32), rng.integers(0, W, P).astype(np.int32)
    unproj = np.abs(proj_range[py, px]) + rng.uniform(0, 2, P).astype(np.float32)
    args = (proj_range, unproj, argmax, px, py)
    got = tpostproc.KNN(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpostproc.KNN(*map(jnp.asarray, args))))


def test_create_fov_dataset_matches_jax(kitti_root, tmp_path):  # noqa: F811
    """The same files as pmf_tpu's tool writes, bit for bit."""
    n = create_fov_dataset(kitti_root, str(tmp_path / "port"), sequences=[0])
    assert n == jcreate_fov(kitti_root, str(tmp_path / "jax"), sequences=[0]) == 3
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                           for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert len(files) == 1 + 3 * 3
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f
    full = np.fromfile(os.path.join(kitti_root, "00", "velodyne", "000000.bin"), np.float32)
    kept = np.fromfile(tmp_path / "port" / "00" / "velodyne" / "000000.bin", np.float32)
    assert 0 < kept.size < full.size
