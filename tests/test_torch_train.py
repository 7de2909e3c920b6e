"""The port's train path against pmf_tpu on the CPU: train-mode BatchNorm,
channel dropout, ColorJitter, the train view with `return_points`, the
PMFNet train-mode forward and the parameter gradients of `pmf_losses`, the
LR schedule and the hybrid optimizer, the focal weights, the tolerant
partial load, and the train CLI end to end. Inputs are made from numpy
seeds; the train view's augmentation is fixed (`aug_override`) and dropout
is off where the two are compared, since the two packages draw other
random numbers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import linen as fnn

from pmf_tpu import data as jdata
from pmf_tpu import models as jmodels
from pmf_tpu import train as jtrain
from pmf_tpu.data import jitter as jjitter
from pmf_tpu.data import perspective_pipeline as jpp
from pmf_tpu.models import layers as jlayers
from pmf_tpu.models.torch_convert import convert_pmf_state_dict
from pmf_tpu.ops import scatter as jscatter
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch.config import Options
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch import train as ttrain
from pmf_tpu_torch.data import jitter as tjitter
from pmf_tpu_torch.models import layers as tlayers
from pmf_tpu_torch.tools import infer_kitti
from pmf_tpu_torch.tools import train as train_cli
from tests.test_data_pipeline import make_synthetic_kitti
from tests.torch_threads import one_torch_thread  # noqa: F401

CFG = dict(canvas_h=64, canvas_w=160, proj_h=64, proj_w=160, proj_ht=48, proj_wt=96,
           h_pad=2, w_pad=2, n_points=1024)
VIEW_KEYS = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
# the fixed train view of the three synthetic scans: flip, θ, crop offsets
FLIP = np.array([True, False, True])
THETA = np.deg2rad(np.array([7.0, -11.0, 3.0])).astype(np.float32)
TOP = np.array([3, 0, 16], np.int32)
LEFT = np.array([5, 52, 0], np.int32)


class _JaxBN(fnn.Module):
    dtype: jnp.dtype = jnp.float32

    @fnn.compact
    def __call__(self, x):
        return jlayers.BatchNorm(dtype=self.dtype, name="bn")(x, use_running_average=False)


def _bn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    c = shape[1]
    return x, {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
               "bias": rng.normal(size=c).astype(np.float32),
               "mean": rng.normal(size=c).astype(np.float32),
               "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _jax_bn(x, p, dtype=jnp.float32):
    """pmf_tpu's train-mode BN on NCHW x: (output NCHW, updated batch stats,
    gradient of sum(y · x) w.r.t. x)."""
    v = {"params": {"bn": {"BatchNorm_0": {"scale": p["scale"], "bias": p["bias"]}}},
         "batch_stats": {"bn": {"BatchNorm_0": {"mean": p["mean"], "var": p["var"]}}}}
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))

    def f(xh):
        y, mut = _JaxBN(dtype).apply(v, xh, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * xh).sum(), (y, mut["batch_stats"]["bn"]["BatchNorm_0"])

    (_, (y, stats)), g = jax.value_and_grad(f, has_aux=True)(xh)
    return (np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2), stats,
            np.asarray(g).transpose(0, 3, 1, 2))


def _port_bn(x, p, cls, dtype=torch.float32):
    bn = cls(x.shape[1]).train()
    with torch.no_grad():
        for name, k in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                        ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(p[k]))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt.to(dtype))
    (y.float() * xt).sum().backward()
    return y.detach().float().numpy(), bn, xt.grad.numpy()


def test_batchnorm_train_running_var_is_biased_as_in_jax():
    """The repaired train branch against pmf_tpu's batch_stats after one
    forward; torch's own BatchNorm2d, which the port's train mode ran
    before, updates the running variance with the unbiased batch variance
    and misses them."""
    x, p = _bn_inputs((4, 2, 3, 3), 0)
    y_j, stats, g_j = _jax_bn(x, p)
    y_t, bn, g_t = _port_bn(x, p, tlayers.BatchNorm2d)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=1e-5)   # through μ and σ²
    _, stock, _ = _port_bn(x, p, torch.nn.BatchNorm2d)
    np.testing.assert_allclose(stock.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    assert not np.allclose(stock.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-3)


def test_batchnorm_train_bfloat16_matches_jax():
    """Statistics in float32 from the bf16 activation, affine in bf16."""
    x, p = _bn_inputs((2, 5, 6, 7), 1)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    y_j, stats, _ = _jax_bn(x, p, jnp.bfloat16)
    y_t, bn, _ = _port_bn(x, p, tlayers.BatchNorm2d, torch.bfloat16)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    np.testing.assert_allclose(y_t, y_j, rtol=2e-2, atol=2e-2)    # one bf16 step


def test_dropout_draws_channels_from_the_generator():
    x = torch.ones(64, 32, 3, 4)
    drop = tlayers.Dropout2d(0.25).train()
    with pytest.raises(ValueError):
        drop(x)
    y1 = drop(x, torch.Generator().manual_seed(3))
    y2 = drop(x, torch.Generator().manual_seed(3))
    assert torch.equal(y1, y2)
    planes = y1.flatten(2)
    assert ((planes == 0).all(-1) | (planes == 1 / 0.75).all(-1)).all()   # whole channels
    assert abs((planes[..., 0] == 0).float().mean().item() - 0.25) < 0.05
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(tlayers.Dropout2d(0.0).train()(x), x)


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1), (1, 2, 0)])
def test_color_jitter_fixed_matches_jax(order):
    rng = np.random.default_rng(2)
    img = np.zeros((2, 20, 30, 3), np.float32)
    img[:, :17, :26] = rng.random((2, 17, 26, 3))
    h, w = np.array([17, 15], np.int32), np.array([26, 30], np.int32)
    f = np.array([[1.3, 0.7, 1.2], [0.8, 1.35, 0.65]], np.float32)
    orders = np.array([order, order[::-1]], np.int32)
    got = tjitter.color_jitter_fixed(*map(torch.from_numpy, (img, h, w, f, orders))).numpy()
    for b in range(2):
        want = jjitter.color_jitter_fixed(jnp.asarray(img[b]), h[b], w[b], f[b], orders[b])
        np.testing.assert_allclose(got[b], np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def kitti_samples(tmp_path_factory):
    root = make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti_train")))
    read = jdata.kitti_sample_reader(jdata.SemanticKitti(root, [0]), jdata.PVConfig(**CFG),
                                     use_native=False)
    samples = [read(i) for i in range(3)]
    return [np.stack([np.asarray(s[k]) for s in samples]) for k in VIEW_KEYS]


def _aug(jitter=None):
    return tdata.AugParams(*map(torch.from_numpy, (FLIP, THETA, TOP, LEFT)), jitter)


def _jax_train_view(arrays, images=None):
    """pmf_tpu's train view of each scan at the fixed parameters: the
    scatter fill (equal to its Pallas fill), normalized, with the points'
    winner flags, stacked."""
    cfg = jpp.PVConfig(**CFG)
    view = jax.jit(lambda *a: jpp._build_view(None, *a[:7], cfg, True, aug_override=a[7:]))
    outs = []
    for b in range(arrays[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in arrays]
        if images is not None:
            args[4] = jnp.asarray(images[b])
        f, m, lab, rows, cols, keep, depth = view(*args, FLIP[b], THETA[b], TOP[b], LEFT[b])
        pix, won = jscatter.point_winner_flags(rows, cols, depth, keep, cfg.proj_ht, cfg.proj_wt)
        outs.append([jpp.normalize_feature(f, m, cfg), m, lab, pix, won])
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(5)]


def test_train_view_matches_jax(kitti_samples):
    """Flip, rotation, crop and pad of the points and the RGB: integer
    outputs and the canvas bit for bit, the normalized features and RGB
    within 1e-6; the winner flags give one point per labelled pixel."""
    got_f, got_m, got_l, (pix, lab, won) = tdata.build_batch(
        *map(torch.from_numpy, kitti_samples), tdata.PVConfig(**CFG), train=True,
        aug_override=_aug(), return_points=True)
    want_f, want_m, want_l, want_pix, want_won = _jax_train_view(kitti_samples)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_array_equal(pix.numpy(), want_pix)
    np.testing.assert_array_equal(won.numpy(), want_won)
    np.testing.assert_array_equal(lab.numpy(), kitti_samples[1])
    np.testing.assert_allclose(got_f.numpy(), want_f, atol=1e-6)
    np.testing.assert_allclose(got_f[..., 5:].numpy(), want_f[..., 5:], atol=1e-6)
    assert got_f.shape == (3, 48, 96, 8) and got_m.sum() > 300
    for b in range(3):
        labelled = (won[b] & (lab[b] > 0)).sum()
        assert labelled == (got_l[b] > 0).sum()


def test_train_view_jitter_and_generator(kitti_samples):
    """ColorJitter in the view is the jitter of the image canvas first; a
    drawn view is reproduced by its generator's seed; a train view without
    a generator raises; `sensor.pcd_aug` turns the 3D point augmentation of
    the `augmentation` group on."""
    cfg = tdata.PVConfig(**CFG, img_jitter=(0.4, 0.4, 0.4))
    ts = list(map(torch.from_numpy, kitti_samples))
    f = torch.tensor([[1.3, 0.7, 1.2], [0.8, 1.35, 0.65], [1.1, 1.0, 0.9]])
    order = torch.tensor([[0, 1, 2], [2, 0, 1], [1, 2, 0]])
    got = tdata.build_batch(*ts, cfg, train=True, aug_override=_aug((f, order)))[0]
    jittered = tjitter.color_jitter_fixed(ts[4], ts[5], ts[6], f, order).numpy()
    want = _jax_train_view(kitti_samples, images=jittered)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)

    draw = lambda seed: tdata.build_batch(*ts, cfg, train=True,
                                          generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(4), draw(4), draw(5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError):
        tdata.build_batch(*ts, cfg, train=True)
    opts = Options(config={"sensor": {**CFG, "pcd_aug": True}, "augmentation": {"p_flipy": 0.5}})
    assert tdata.pv_config(opts).pcd_aug and tdata.pv_config(opts).augment.p_flipy == 0.5
    opts.config["sensor"]["pcd_aug"] = False
    assert not tdata.pv_config(opts).pcd_aug
    assert tdata.pv_config(opts).img_jitter == (0.4, 0.4, 0.4)


def _named_grads(model):
    """The model's parameter gradients with zero BN statistics beside them,
    in the shape of a state_dict that pmf_tpu's converter maps onto the flax
    tree (the conversion is linear, so gradients map as weights do)."""
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    sd.update({k: p.grad for k, p in model.named_parameters()})
    return convert_pmf_state_dict({k: v.numpy() for k, v in sd.items()})[0]


def test_pmfnet_train_step_gradients_match_jax(kitti_samples):
    """The slice as a whole, at dropout 0: the train view, PMFNet in train
    mode, `pmf_losses` with the point-domain Lovász pair, and backward.
    Every loss term within 1e-5 and the BN running statistics after the
    forward within 1e-5.

    The parameter gradients of this float32 network move with the last
    bits of the forward pass (the kinks of ReLU and max pooling):
    pmf_tpu's own gradients of the same batch given in another order
    differ by percents of a leaf's norm in the encoder's last stage. So
    each gradient is held to 1e-4 of its norm, or, where pmf_tpu moves more
    than that between the batch and two reorderings of it, to 10 times its
    larger move: the port sums every convolution in another order too, so
    it lands a few times as far."""
    model = tmodels.random_weights(tmodels.PMFNet(nclasses=20, base_channels=8,
                                                  dropout_rate=0.0), seed=21).train()
    # copies: the train-mode forward below updates the BN statistics in place
    params, stats = convert_pmf_state_dict(
        {k: v.numpy().copy() for k, v in model.state_dict().items()})
    f, _, label, points = tdata.build_batch(*map(torch.from_numpy, kitti_samples),
                                            tdata.PVConfig(**CFG), train=True,
                                            aug_override=_aug(), return_points=True)
    alpha = tuple(np.random.default_rng(22).uniform(0.2, 1, 20).astype(np.float32).tolist())
    cfg_t = ttrain.LossConfig(alpha=alpha)
    cfg_j = jtrain.LossConfig(alpha=alpha)

    lidar, cam = model(f[..., :5], f[..., 5:8])
    total, aux = ttrain.pmf_losses(lidar, cam, label, cfg_t, points)
    total.backward()

    jmodel = jmodels.PMFNet(nclasses=20, base_channels=8, dropout_rate=0.0)

    def loss_fn(p, feature, lab, pts):
        (lp, cp), mut = jmodel.apply({"params": p, "batch_stats": stats}, feature[..., :5],
                                     feature[..., 5:8], train=True, mutable=["batch_stats"])
        tot, jaux = jtrain.steps.pmf_losses(lp, cp, lab, cfg_j, points=pts)
        return tot, (jaux, mut["batch_stats"])

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    batch = [f.numpy(), label.numpy(), *(t.numpy() for t in points)]
    grads, (jaux, jstats) = grad_fn(params, *map(jnp.asarray, batch[:2]),
                                    tuple(map(jnp.asarray, batch[2:])))
    reordered = [grad_fn(params, *(jnp.asarray(a[order]) for a in batch[:2]),
                         tuple(jnp.asarray(a[order]) for a in batch[2:]))[0]
                 for order in ([2, 0, 1], [1, 2, 0])]
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5, err_msg=k)
    _, new_stats = convert_pmf_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    assert jax.tree_util.tree_structure(new_stats) == jax.tree_util.tree_structure(jstats)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(new_stats)[0],
                            jax.tree_util.tree_leaves(jstats)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    got = _named_grads(model)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(grads)
    paths = jax.tree_util.tree_flatten_with_path(got)[0]
    for (path, g), w, *others in zip(paths, *map(jax.tree_util.tree_leaves, [grads, *reordered])):
        w = np.asarray(w)
        err, norm = np.linalg.norm(g - w), np.linalg.norm(w)
        noise = max(np.linalg.norm(np.asarray(o) - w) for o in others)
        assert err <= max(1e-4 * norm, 10 * noise) + 1e-7, \
            (jax.tree_util.keystr(path), err, noise, norm)
    assert sum(np.abs(g).sum() > 0 for _, g in paths) == len(paths)


def test_warmup_cosine_lr_matches_jax():
    got = ttrain.warmup_cosine_lr(1e-3, 100, 1000)
    want = jtrain.warmup_cosine_lr(1e-3, 100, 1000)
    for step in (0, 1, 50, 99, 100, 101, 600, 1099, 1100, 5000):
        # pmf_tpu's schedule is float32: 1e-6 of the peak rate
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-9)


class _ThreeStreams(torch.nn.Module):
    """Parameters under the PMF model's three top-level names."""

    def __init__(self, shapes):
        super().__init__()
        for top, names in shapes.items():
            setattr(self, top, torch.nn.ParameterDict(
                {n: torch.nn.Parameter(torch.zeros(s)) for n, s in names.items()}))


def test_hybrid_optimizer_matches_optax():
    """Three updates of AdamW (lidar stream) and SGD-Nesterov with weight
    decay (camera streams), fed the same gradients, through a warmup whose
    first learning rate is 0."""
    shapes = {"lidar_stream": {"a": (3, 4), "b": (5,)},
              "camera_stream_encoder": {"c": (2, 3)}, "camera_stream_decoder": {"d": (4,)}}
    rng = np.random.default_rng(30)
    p0 = {t: {n: rng.normal(size=s).astype(np.float32) for n, s in d.items()}
          for t, d in shapes.items()}
    model = _ThreeStreams(shapes)
    with torch.no_grad():
        for t, d in p0.items():
            for n, v in d.items():
                getattr(model, t)[n].copy_(torch.from_numpy(v))
    opt = ttrain.HybridOptimizer(model, ttrain.warmup_cosine_lr(1e-2, 2, 10), 0.9, 1e-4)
    tx = jtrain.hybrid_pmf_optimizer(jtrain.warmup_cosine_lr(1e-2, 2, 10), 0.9, 1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda v: rng.normal(size=v.shape).astype(np.float32), p0)
        for t, d in g.items():
            for n, v in d.items():
                getattr(model, t)[n].grad = torch.from_numpy(v)
        opt.step()
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        for t, d in params.items():
            for n, v in d.items():
                np.testing.assert_allclose(getattr(model, t)[n].detach().numpy(), np.asarray(v),
                                           rtol=1e-6, atol=1e-6, err_msg=f"{t}.{n} step {step}")
    moved = {t: np.abs(np.asarray(params[t]["c" if t == "camera_stream_encoder" else
                                              ("d" if t == "camera_stream_decoder" else "a")])
                       - p0[t]["c" if t == "camera_stream_encoder" else
                              ("d" if t == "camera_stream_decoder" else "a")]).max()
             for t in p0}
    assert min(moved.values()) > 1e-4
    state_dict = opt.state_dict()
    opt2 = ttrain.HybridOptimizer(model, ttrain.warmup_cosine_lr(1e-2, 2, 10), 0.9, 1e-4)
    opt2.load_state_dict(state_dict)
    assert opt2.steps == 3 and opt2.lr == opt.lr


def test_focal_alpha_and_class_frequencies_match_jax(tmp_path):
    freq = np.random.default_rng(31).uniform(0, 0.2, 20).astype(np.float32)
    ignore = {0: True, 5: True}
    np.testing.assert_array_equal(ttrain.kitti_focal_alpha(freq.copy(), ignore),
                                  jtrain.kitti_focal_alpha(freq.copy(), ignore))
    counts = np.random.default_rng(32).integers(1, 10**6, 20).tolist()
    np.testing.assert_array_equal(ttrain.config_focal_alpha(counts),
                                  jtrain.trainer.config_focal_alpha(counts))
    root = make_synthetic_kitti(str(tmp_path), n_scans=1)
    np.testing.assert_array_equal(tdata.SemanticKitti(root, [0]).cls_freq,
                                  jdata.SemanticKitti(root, [0]).cls_freq)


def test_partial_load_matches_jax():
    rng = np.random.default_rng(33)
    target = {"a.weight": rng.normal(size=(3, 2)), "a.bias": rng.normal(size=3),
              "b.weight": rng.normal(size=(4, 4)), "c": rng.normal(size=2)}
    source = {"a.weight": rng.normal(size=(3, 2)), "a.bias": rng.normal(size=4),
              "b.weight": rng.normal(size=(4, 4)), "d": rng.normal(size=2)}
    got = ttrain.partial_load({k: torch.from_numpy(v) for k, v in target.items()},
                              {k: torch.from_numpy(v) for k, v in source.items()})
    nest = lambda d: {k.split(".")[0]: {} for k in d}
    jt, js = nest(target), nest(source)
    for tree, flat in ((jt, target), (js, source)):
        for k, v in flat.items():
            top, *rest = k.split(".")
            if rest:
                tree[top][rest[0]] = v
            else:
                tree[top] = v
    want = jtrain.partial_load(jt, js)
    for k, v in got.items():
        top, *rest = k.split(".")
        np.testing.assert_array_equal(v.numpy(), want[top][rest[0]] if rest else want[top])
    assert torch.equal(got["a.weight"], torch.from_numpy(source["a.weight"]))
    assert torch.equal(got["a.bias"], torch.from_numpy(target["a.bias"]))


@pytest.fixture(scope="module")
def cli_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    data = make_synthetic_kitti(str(root / "sequences"), n_scans=2, n_points=800)
    for seq in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
        os.symlink(os.path.join(data, "00"), os.path.join(data, f"{seq:02d}"))
    cfg = {
        "save_path": str(root / "runs"), "seed": 3, "experiment_id": "cli",
        "n_epochs": 2, "batch_size": [2, 2], "lr": 0.01, "warmup_epochs": 1,
        "dataset": "SemanticKitti", "nclasses": 20, "data_root": data,
        "net_type": "PMFNet", "base_channels": 8, "img_backbone": "resnet34",
        "compute_dtype": "float32", "lambda": 1.0, "gamma": 0.5, "tau": 0.7,
        "augmentation": {"img_jitter": [0.4, 0.4, 0.4]},
        "sensor": {**CFG, "pcd_aug": False,
                   "img_mean": [12.12, 10.88, 0.23, -1.04, 0.21],
                   "img_stds": [12.32, 11.47, 6.91, 0.86, 0.16]},
    }
    path = str(root / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def test_train_cli_writes_checkpoints_that_infer_kitti_loads(cli_config):
    """`tools/train.py --device cpu --debug`: a resume checkpoint and best
    snapshots; the last snapshot loads through `tools/infer_kitti.py`, and a
    run with `checkpoint` set resumes after the saved epoch."""
    path, cfg = cli_config
    best = train_cli.main([path, "--device", "cpu", "--debug"])
    assert set(best) == {"Acc", "IOU", "Recall"}
    run_dir = os.path.join(cfg["save_path"], "SemanticKitti-PMFNet-resnet34-bs2-lr0.01-cli")
    ckpt = os.path.join(run_dir, "checkpoint")
    assert os.path.exists(os.path.join(ckpt, "checkpoint.pth"))
    snapshot = os.path.join(ckpt, "best_last_model.pth")
    assert os.path.exists(snapshot)
    log = open(os.path.join(run_dir, "log", "experiment.log")).read()
    assert log.count(">>> Train") == 2 and log.count(">>> Validation") == 2

    out = infer_kitti.main([path, "--weights", snapshot, "--max-scans", "1", "--device", "cpu"])
    assert np.isfinite(out["point"]["mIoU"])

    state = torch.load(os.path.join(ckpt, "checkpoint.pth"), weights_only=True)
    assert state["epoch"] == 1 and state["optimizer"]["steps"] == 2
    resumed = dict(cfg, checkpoint=True, n_epochs=3)
    with open(path, "w") as f:
        yaml.safe_dump(resumed, f)
    train_cli.main([path, "--device", "cpu", "--debug"])
    state = torch.load(os.path.join(ckpt, "checkpoint.pth"), weights_only=True)
    assert state["epoch"] == 2 and state["optimizer"]["steps"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_cli.main([path])
