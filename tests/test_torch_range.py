"""The port's range view and 3D point augmentation against pmf_tpu on the
CPU: `spherical_project`, `augment_pointcloud` (with pmf_tpu's draws as the
override), `range_config` against both pmf_tpu readers, `range_project`,
`build_range_batch` (eval, and train with pmf_tpu's draws) and the per-scan
`build_range_sample_with_uproj`, each through K1's plain version; and the
point augmentation wired into the PMF and EPMF train views. Inputs are made
from numpy seeds; pmf_tpu's results and draws are derived under `jax.jit`,
as pmf_tpu runs them."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.config import load_options as jload_options
from pmf_tpu.data import augment as jaug
from pmf_tpu.data import perspective_pipeline as jpp
from pmf_tpu.data import perspective_pipeline_v2 as jv2
from pmf_tpu.data import range_pipeline as jrange
from pmf_tpu.ops import projection as jproj
from pmf_tpu.ops import scatter as jscatter
from pmf_tpu.tools import infer_salsanext as jinfer_salsanext
from pmf_tpu.train import trainer as jtrainer
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch.config import load_options
from pmf_tpu_torch.data.synthetic import make_range_inputs
from pmf_tpu_torch.ops import projection as tproj
from pmf_tpu_torch.ops import scatter as tscatter
from pmf_tpu_torch.ops import zbuffer as tzbuf
from tests.test_torch_epmf import _Stop, _jax_draws, _stop, pallas_interpret, samples  # noqa: F401
from tests.test_torch_epmf import CFG as V2_CFG
from tests.test_torch_train import CFG as PV_CFG
from tests.test_torch_train import kitti_samples  # noqa: F401

SALSANEXT_KITTI = os.path.join(os.path.dirname(__file__), "..", "configs", "experiments",
                               "salsanext_kitti.yaml")
H, W = 16, 128
AUG = load_options(SALSANEXT_KITTI).group("augmentation")   # the yaml's, reversed yaw included


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several test processes side by
    side on the cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scans(seed: int, b: int, n: int):
    """`make_range_inputs` from a seed: points all around the sensor, some
    above and below the 3°/-25° field of view, a tenth of them ties, the
    last 100 padding."""
    return make_range_inputs(np.random.default_rng(seed), b, n, n - 100)


def _ulps(a, b):
    """|a - b| in ulps of float32 b, elementwise."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))


def _jax_range_cfg(**kw):
    return jrange.RangeConfig(proj_h=H, proj_w=W, n_points=4096, **kw)


def _port_range_cfg(**kw):
    return tdata.RangeConfig(proj_h=H, proj_w=W, n_points=4096, **kw)


@pytest.mark.parametrize("fov", [(3.0, -25.0, -180.0, 180.0), (10.0, -30.0, -90.0, 150.0)])
def test_spherical_project_matches_jax(fov):
    """px/py equal except at points whose unfloored coordinate lies within
    1e-4 px of an integer (atan2 and asin round differently in the last
    place in the two packages); the range within 1 ulp."""
    pts, _, valid = scans(1, 2, 4096)
    args = (fov[0], fov[1], H, W, fov[2], fov[3])
    got = tproj.spherical_project(torch.from_numpy(pts), *args[:4], *args[4:],
                                  valid=torch.from_numpy(valid))
    want = [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda p, v: jproj.spherical_project(p, *args, valid=v)))(pts, valid)]
    p = pts.astype(np.float64)
    r = np.linalg.norm(p[..., :3], axis=-1)
    fov_v = abs(np.deg2rad(fov[0])) + abs(np.deg2rad(fov[1]))
    fov_h = abs(np.deg2rad(fov[2])) + abs(np.deg2rad(fov[3]))
    x = (-np.arctan2(p[..., 1], p[..., 0]) + abs(np.deg2rad(fov[2]))) / fov_h * W
    y = (1 - (np.arcsin(p[..., 2] / r) + abs(np.deg2rad(fov[1]))) / fov_v) * H
    edge = (np.abs(x - np.round(x)) < 1e-4) | (np.abs(y - np.round(y)) < 1e-4)
    print(f"{edge.sum()} of {edge.size} points within 1e-4 px of a pixel edge")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy()[~edge], w[~edge])
    assert _ulps(got[2].numpy(), want[2]).max() <= 1
    np.testing.assert_array_equal(got[3].numpy(), valid)
    clamped = (got[0] == 0) | (got[0] == W - 1) | (got[1] == 0) | (got[1] == H - 1)
    assert clamped.sum() > 0 and got[0].unique().numel() > W // 2


def point_aug_override(keys, cfg) -> tdata.PointAugParams:
    """pmf_tpu's point-augmentation draws from each scan's key, made as
    `augment_pointcloud` makes them, under jit, stacked as a
    PointAugParams: sign [B, 3], translation [B, 3], yaw, pitch, roll [B]."""

    def draw(k):
        keys = jax.random.split(k, 9)

        def maybe(k1, k2, p, lo, hi):
            v = jax.random.uniform(k2, minval=lo, maxval=hi)
            return jnp.where(jax.random.uniform(k1) < p, v, 0.0)

        sign = jnp.array([jnp.where(jax.random.uniform(keys[0]) < cfg.p_flipx, -1.0, 1.0),
                          jnp.where(jax.random.uniform(keys[1]) < cfg.p_flipy, -1.0, 1.0), 1.0])
        t = jnp.stack([maybe(keys[2], keys[3], cfg.p_transx, cfg.trans_xmin, cfg.trans_xmax),
                       maybe(keys[4], keys[5], cfg.p_transy, cfg.trans_ymin, cfg.trans_ymax),
                       maybe(keys[6], keys[7], cfg.p_transz, cfg.trans_zmin, cfg.trans_zmax)])
        rk = jax.random.split(keys[8], 6)
        roll = maybe(rk[0], rk[1], cfg.p_rot_roll, cfg.rot_rollmin, cfg.rot_rollmax)
        pitch = maybe(rk[2], rk[3], cfg.p_rot_pitch, cfg.rot_pitchmin, cfg.rot_pitchmax)
        yaw = maybe(rk[4], rk[5], cfg.p_rot_yaw, cfg.rot_yawmin, cfg.rot_yawmax)
        return sign, t, yaw, pitch, roll

    draws = jax.jit(jax.vmap(draw))(jnp.stack(list(keys)))
    return tdata.PointAugParams(*(torch.from_numpy(np.asarray(d)) for d in draws))


def test_augment_pointcloud_matches_jax():
    """With pmf_tpu's draws as the override (the yaml's augmentation, all
    probabilities raised to 1 for rotations here so every scan rotates): xyz
    within 2 ulp of each point's largest coordinate (the two packages sum
    the rotation's products in other orders), intensity exact. The reversed
    yaw bounds (5, -5) give yaw 5 in both."""
    cfg_t = tdata.AugmentConfig.from_dict({**AUG, "p_rot_yaw": 1, "p_rot_pitch": 1,
                                           "p_rot_roll": 1, "img_jitter": [0.4] * 3})
    cfg_j = jaug.AugmentConfig.from_dict(dataclasses.asdict(cfg_t))
    pts, _, _ = scans(2, 4, 4096)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.asarray(jax.jit(jax.vmap(lambda k, p: jaug.augment_pointcloud(k, p, cfg_j)))(
        keys, pts))
    params = point_aug_override(keys, cfg_j)
    assert torch.equal(params.yaw, torch.full((4,), 5.0))
    got = tdata.augment_pointcloud(torch.from_numpy(pts), cfg_t, params=params).numpy()
    scale = np.spacing(np.abs(want[..., :3]).max(-1, keepdims=True))
    err = np.abs(got[..., :3].astype(np.float64) - want[..., :3]) / scale
    print(f"xyz: max {err.max():.2f} ulp of the point's largest coordinate, "
          f"{(got[..., :3] != want[..., :3]).mean():.4f} of the values differ")
    assert err.max() <= 2
    np.testing.assert_array_equal(got[..., 3], want[..., 3])


def test_augment_draws_from_generator():
    """Reproduced by the generator's seed, different with another; the
    reversed yaw bounds give 5 wherever the yaw is drawn; no generator and
    no override raises."""
    cfg = tdata.AugmentConfig.from_dict(AUG)
    pts = torch.from_numpy(scans(3, 64, 16)[0])
    draw = lambda seed: tdata.augment_pointcloud(pts, cfg, torch.Generator().manual_seed(seed))
    assert torch.equal(draw(1), draw(1)) and not torch.equal(draw(1), draw(2))
    params = tdata.augment.draw_point_aug(torch.Generator().manual_seed(4), 64, cfg)
    assert set(params.yaw.unique().tolist()) == {0.0, 5.0}
    assert set(params.sign[:, 0].tolist()) == {1.0} and set(params.sign[:, 1].tolist()) == {-1.0, 1.0}
    assert ((params.translation[:, 2] <= 0) & (params.translation[:, 2] >= -1)).all()
    with pytest.raises(ValueError):
        tdata.augment_pointcloud(pts, cfg)


def test_range_config_matches_both_jax_readers(monkeypatch):
    """`range_config` of the shipped salsanext_kitti.yaml against the
    RangeConfig that pmf_tpu's trainer and its SalsaNext eval CLI build
    from it (each stopped right after, before it reads a dataset)."""
    opts = load_options(SALSANEXT_KITTI)
    jopts = jload_options(SALSANEXT_KITTI)
    trainer = jtrainer.Trainer.__new__(jtrainer.Trainer)
    trainer.opts = jopts
    monkeypatch.setattr(jtrainer, "SemanticKitti",
                        lambda *a, **k: type("Dataset", (), {"mapped_cls_name": {},
                                                             "cls_freq": np.ones(20),
                                                             "data_config": {"learning_ignore": {}}})())
    monkeypatch.setattr(jtrainer, "range_sample_reader", _stop)
    with pytest.raises(_Stop):
        trainer._init_data()
    inf = jinfer_salsanext.SalsaNextInference.__new__(jinfer_salsanext.SalsaNextInference)
    monkeypatch.setattr(jinfer_salsanext, "SemanticKitti", _stop)
    with pytest.raises(_Stop):
        inf.__init__(jopts, "unused")
    for got, want in ((tdata.range_config(opts), trainer.range_cfg),
                      (tdata.range_config(opts, eval_cli=True), inf.cfg)):
        for field in dataclasses.fields(tdata.RangeConfig):
            a, b = getattr(got, field.name), getattr(want, field.name)
            if field.name == "augment":
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, field.name
    got = tdata.range_config(opts)
    assert (got.proj_h, got.proj_w, got.fov_up, got.n_points) == (64, 2048, 3.0, 131072)
    assert got.pcd_aug and (got.augment.rot_yawmin, got.augment.rot_yawmax) == (5.0, -5.0)
    assert not tdata.range_config(opts, eval_cli=True).pcd_aug
    defaults = tdata.range_config(type(opts)(), eval_cli=True)
    assert (defaults.fov_up, defaults.fov_down) == (10.0, -30.0)


def _check_planes(got: dict, want: dict):
    """Range planes held: mask, labels, px, py, keep bit for bit; ranges
    within 1 ulp."""
    for k in ("mask", "label", "px", "py", "keep"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("proj_range", "depth"):
        assert _ulps(got[k].numpy(), want[k]).max() <= 1, k


def test_range_project_matches_jax():
    """A batch of scans through `range_project` (one call of K1's plain
    version for the batch) against pmf_tpu's per scan; and the port's
    batched `zbuffer_scatter_packed` against pmf_tpu's on the same pixels:
    winners bit for bit."""
    pts, labels, valid = scans(4, 3, 4096)
    cfg_j, cfg_t = _jax_range_cfg(), _port_range_cfg()
    got = tdata.range_project(*map(torch.from_numpy, (pts, labels, valid)), cfg_t)
    want = jax.jit(jax.vmap(lambda p, l, v: jrange.range_project(p, l, v, cfg_j)))(
        pts, labels, valid)
    _check_planes(got, want)
    np.testing.assert_array_equal(got["feature"][..., 1:].numpy(),       # x, y, z, intensity
                                  np.asarray(want["feature"])[..., 1:])
    assert got["mask"].sum() > 2000 and (got["label"] > 0).sum() > 1500

    rows, cols, depth, keep = (np.asarray(want[k]) for k in ("py", "px", "depth", "keep"))
    win_t, mask_t = tscatter.zbuffer_scatter_packed(*map(torch.from_numpy, (rows, cols, depth, keep)),
                                                    H, W, keys=tzbuf.zbuffer_keys_plain)
    win_j, mask_j = jax.jit(jax.vmap(lambda *a: jscatter.zbuffer_scatter_packed(*a, H, W)))(
        rows, cols, depth, keep)
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


@pytest.mark.parametrize("train", [False, True])
def test_build_range_batch_matches_jax(train):
    """`build_range_batch` at eval, and in train with the yaml's point
    augmentation and pmf_tpu's draws as the override, against pmf_tpu's:
    mask and labels bit for bit, normalized features within 1e-6."""
    pts, labels, valid = scans(5, 3, 4096)
    aug_j = jaug.AugmentConfig.from_dict(AUG)
    cfg_j = _jax_range_cfg(augment=aug_j)
    cfg_t = _port_range_cfg(augment=tdata.AugmentConfig.from_dict(AUG))
    key = jax.random.PRNGKey(6)
    want = [np.asarray(a) for a in jrange.build_range_batch(key, pts, labels, valid, cfg_j, train)]
    override = point_aug_override(jax.random.split(key, 3), aug_j) if train else None
    got = tdata.build_range_batch(*map(torch.from_numpy, (pts, labels, valid)), cfg_t, train,
                                  aug_override=override)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6)
    assert got[0].shape == (3, H, W, 5) and got[2].sum() > 2000
    if train:
        assert (override.sign[:, 1] == -1).any() and (override.translation != 0).any()
        plain = tdata.build_range_batch(*map(torch.from_numpy, (pts, labels, valid)), cfg_t)
        assert not torch.equal(plain[2], got[2])


@pytest.mark.parametrize("n", [4096, 131072])
def test_range_sample_with_uproj_matches_jax(n):
    """The per-scan eval view (K1's plain version and a gather) against
    pmf_tpu's: every output bit for bit but the ranges (1 ulp) and the
    normalized features (1e-6). At 131072 points the keys carry 17 index
    bits and clip depth at 256 m, in both packages; some points lie beyond
    it."""
    pts, labels, valid = scans(7, 1, n)
    if n > 4096:
        pts[0, ::7, :3] *= 6.0
    cfg_j = jrange.RangeConfig(proj_h=H, proj_w=W, n_points=n, fov_up=10.0, fov_down=-30.0,
                               pcd_aug=False)
    cfg_t = tdata.RangeConfig(proj_h=H, proj_w=W, n_points=n, fov_up=10.0, fov_down=-30.0,
                              pcd_aug=False)
    want = jrange.build_range_sample_with_uproj(pts[0], labels[0], valid[0], cfg_j)
    got = tdata.build_range_sample_with_uproj(*(torch.from_numpy(a[0]) for a in
                                                (pts, labels, valid)), cfg_t)
    names = ("feature", "label", "mask", "proj_range", "px", "py", "depth", "keep")
    _check_planes(dict(zip(names, got)), dict(zip(names, want)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert got[2].sum() > 1000
    if n > 4096:
        assert (got[6] > 256).sum() > 1000


def _pv_point_draws(key, arrays, cfg_j):
    """pmf_tpu's draws for each scan of `build_batch(key, ...)` with pcd_aug:
    the point augmentation from the scan's key and the view's flip, theta
    and crop from fold_in(key, 1), under jit."""
    keys = jax.random.split(key, arrays[0].shape[0])
    affine = jax.jit(lambda k, h, w: jpp._affine_params(jax.random.fold_in(k, 1), h, w, cfg_j,
                                                         True))
    flip, theta, top, left = (np.stack([np.asarray(affine(k, arrays[5][b], arrays[6][b])[i])
                                        for b, k in enumerate(keys)]) for i in range(4))
    return tdata.AugParams(*map(torch.from_numpy, (flip, theta, top.astype(np.int64),
                                                   left.astype(np.int64))),
                           points=point_aug_override(keys, cfg_j.augment))


def test_pmf_train_view_pcd_aug_matches_jax(kitti_samples):  # noqa: F811
    """The PMF train view with `pcd_aug` (the yaml's point augmentation)
    against pmf_tpu's `build_batch`, with pmf_tpu's draws as the override:
    mask, labels and winner flags bit for bit, features within 1e-6."""
    aug = dict(AUG, p_rot_yaw=1.0, rot_yawmin=-5.0, rot_yawmax=5.0)
    cfg_j = jpp.PVConfig(**PV_CFG, pcd_aug=True, augment=jaug.AugmentConfig.from_dict(aug),
                         fill="scatter")
    cfg_t = tdata.PVConfig(**PV_CFG, pcd_aug=True, augment=tdata.AugmentConfig.from_dict(aug))
    key = jax.random.PRNGKey(8)
    want = jpp.build_batch(key, *kitti_samples, cfg_j, True, return_points=True)
    override = _pv_point_draws(key, kitti_samples, cfg_j)
    got = tdata.build_batch(*map(torch.from_numpy, kitti_samples), cfg_t, train=True,
                            aug_override=override, return_points=True)
    for g, w in ((got[1], want[1]), (got[2], want[2]), *zip(got[3], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert got[1].sum() > 300
    plain = tdata.build_batch(*map(torch.from_numpy, kitti_samples), tdata.PVConfig(**PV_CFG),
                              train=True, aug_override=override._replace(points=None))
    assert not torch.equal(plain[1], got[1])
    with pytest.raises(ValueError):
        tdata.build_batch(*map(torch.from_numpy, kitti_samples), cfg_t, train=True,
                          aug_override=override._replace(points=None))


def test_v2_train_view_pcd_aug_matches_jax(samples, pallas_interpret):  # noqa: F811
    """The EPMF V2 train view with `pcd_aug` against pmf_tpu's
    `build_v2_batch` (Pallas fill in interpret mode), with pmf_tpu's draws
    (the point augmentation, then scale, flip, rotation, crop and
    ColorJitter over the augmented points' box) as the override: mask,
    labels and winner flags bit for bit, lidar features within 1e-6. The
    bilinear RGB's weights come from source coordinates of 50-130 px, whose
    last bit (4-8e-6) XLA's fused multiply-adds move, with or without the
    point augmentation (9e-6 at these draws): RGB within 2e-5."""
    aug = dict(AUG, p_rot_yaw=1.0, rot_yawmin=-5.0, rot_yawmax=5.0)
    aug_j = jaug.AugmentConfig.from_dict(aug)
    cfg_j = jv2.V2Config(**V2_CFG, img_jitter=(0.4, 0.4, 0.4), fill="pallas", pcd_aug=True,
                         augment=aug_j)
    cfg_t = tdata.V2Config(**V2_CFG, img_jitter=(0.4, 0.4, 0.4), pcd_aug=True,
                           augment=tdata.AugmentConfig.from_dict(aug))
    key = jax.random.PRNGKey(9)
    aug_keys = [jax.random.split(k, 6)[0] for k in jax.random.split(key, 3)]
    augmented = np.stack([np.asarray(jax.jit(lambda k, p: jaug.augment_pointcloud(k, p, aug_j))(
        k, samples[0][b])) for b, k in enumerate(aug_keys)])
    override = _jax_draws(key, [augmented, *samples[1:]], cfg_j, 3)._replace(
        points=point_aug_override(aug_keys, aug_j))
    want = jv2.build_v2_batch(key, *map(jnp.asarray, samples), cfg_j, True, return_points=True)
    got = tdata.build_v2_batch(*map(torch.from_numpy, samples), cfg_t, True,
                               aug_override=override, return_points=True)
    for g, w in ((got[1], want[1]), (got[2], want[2]), *zip(got[3], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_f = np.asarray(want[0])
    np.testing.assert_allclose(got[0][..., :5].numpy(), want_f[..., :5], atol=1e-6)
    np.testing.assert_allclose(got[0][..., 5:].numpy(), want_f[..., 5:], atol=2e-5)
    assert got[1].sum() > 300
