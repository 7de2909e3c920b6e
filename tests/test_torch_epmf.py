"""The port's EPMF eval path against pmf_tpu on the CPU: the yaw-crop
projection, the V2 view (its config, the batched view through K2's plain
version and the per-scan view through K1's, eval and train), EPMFNet and its
converter, and the eval CLI's EPMF branch. Inputs are made from numpy
seeds; the train view takes pmf_tpu's own random draws as its
`aug_override`."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pmf_tpu import models as jmodels
from pmf_tpu.config import load_options as jload_options
from pmf_tpu.data import SemanticKitti, kitti_sample_reader
from pmf_tpu.data import perspective_pipeline_v2 as jv2
from pmf_tpu.models.torch_convert import convert_pmf_state_dict
from pmf_tpu.ops import projection as jproj
from pmf_tpu.ops.pallas import tile_fill
from pmf_tpu.tools import infer_kitti as jinfer
from pmf_tpu.train import trainer as jtrainer
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch.config import load_options
from pmf_tpu_torch.ops import projection as tproj
from pmf_tpu_torch.tools import infer_kitti
from tests.test_data_pipeline import make_synthetic_kitti
from tests.test_torch_infer_kitti import _TemplateInit, _labels
from tests.test_torch_models import _check_probs, _numpy_sd, random_flax_tree, save_flat_flax_npz

CFG = dict(canvas_h=64, canvas_w=160, proj_h=64, proj_w=128, proj_ht=64, proj_wt=128,
           n_points=1024)
VIEW_KEYS = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
EPMF_KITTI = os.path.join(os.path.dirname(__file__), "..", "configs", "experiments",
                          "epmf_kitti.yaml")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several test processes side by
    side on the cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Three synthetic scans as stacked numpy arrays, in VIEW_KEYS order."""
    root = make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti_epmf")), n_points=700)
    read = kitti_sample_reader(SemanticKitti(root, [0]), jv2.V2Config(**CFG), use_native=False)
    scans = [read(i) for i in range(3)]
    return [np.stack([np.asarray(s[k]) for s in scans]) for k in VIEW_KEYS]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """pmf_tpu's tile rasterizer in interpret mode, as its own tests run it
    on the CPU."""
    orig = tile_fill.rasterize_zbuffer_pallas
    monkeypatch.setattr(tile_fill, "rasterize_zbuffer_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def test_yaw_crop_project_matches_jax():
    """Points all around the sensor, some on the ±45° edges, some within
    0.5 m: pixel coordinates bit for bit, keep exactly."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-30, 30, (2, 4096, 3)).astype(np.float32)
    pts[:, :64, 1] = pts[:, :64, 0]                         # yaw exactly -45°
    pts[:, 64:128, 1] = -pts[:, 64:128, 0]                  # and +45°
    pts[:, 128:160] *= 0.01                                 # closer than 0.5 m
    valid = rng.random((2, 4096)) > 0.1
    P = np.array([[60, -80, 0, 3], [30, 0, -80, 2], [1, 0.01, 0, 0.5]], np.float32)
    got = tproj.yaw_crop_project(torch.from_numpy(pts), torch.from_numpy(P)[None].expand(2, 3, 4),
                                 valid=torch.from_numpy(valid))
    for b in range(2):
        want = jproj.yaw_crop_project(jnp.asarray(pts[b]), jnp.asarray(P),
                                      valid=jnp.asarray(valid[b]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    assert 0 < got[2].sum() < got[2].numel()


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


def test_v2_config_matches_both_jax_readers(monkeypatch):
    """`v2_config` of the shipped epmf_kitti.yaml against the V2Config that
    pmf_tpu's eval CLI and its trainer build from it (each stopped right
    after, before it reads a dataset); `pcd_aug` turns the point
    augmentation of the `augmentation` group on."""
    got = tdata.v2_config(load_options(EPMF_KITTI))
    jopts = jload_options(EPMF_KITTI)
    inf = jinfer.Inference.__new__(jinfer.Inference)
    monkeypatch.setattr(jinfer, "SemanticKitti", _stop)
    with pytest.raises(_Stop):
        inf.__init__(jopts, "unused")
    trainer = jtrainer.Trainer.__new__(jtrainer.Trainer)
    trainer.opts = jopts
    monkeypatch.setattr(jtrainer, "SemanticKitti",
                        lambda *a, **k: type("Dataset", (), {"mapped_cls_name": {}})())
    monkeypatch.setattr(jtrainer, "kitti_sample_reader", _stop)
    with pytest.raises(_Stop):
        trainer._init_data()
    as_value = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    for field in dataclasses.fields(tdata.V2Config):
        value = as_value(getattr(got, field.name))
        if field.name not in ("img_jitter", "augment"):   # train-only: the eval CLI's defaults
            assert value == as_value(getattr(inf.pv_cfg, field.name)), field.name
        assert value == as_value(getattr(trainer.v2_cfg, field.name)), field.name
    assert (got.proj_h, got.proj_w, got.n_points) == (320, 1280, 131072)
    assert got.img_jitter == (0.4, 0.4, 0.4) and inf.pv_cfg.img_jitter is None
    assert tdata.view_config(load_options(EPMF_KITTI)) == got
    opts = load_options(EPMF_KITTI)
    assert not got.pcd_aug and got.augment.p_flipy == 0.5
    opts.config["PVconfig"]["pcd_aug"] = True
    assert tdata.v2_config(opts).pcd_aug


def _jax_draws(key, arrays, cfg, B):
    """pmf_tpu's train-view draws for each scan of the batch, made from
    `key` exactly as `build_v2_batch` and `_v2_geometry` make them, under
    jit as they run (XLA folds theta's π/180 there, which moves its last
    bit): scale, flip, theta, top, left and the ColorJitter (factors,
    order)."""
    out_h, out_w = cfg.proj_ht, cfg.proj_wt

    @jax.jit
    def draw(k, pts, valid, P):
        _, k_scale, k_flip, k_rot, k_top, k_left = jax.random.split(k, 6)
        scale = jax.random.uniform(k_scale, minval=cfg.scale_min, maxval=cfg.scale_max)
        rows_f, cols_f, keep = jproj.yaw_crop_project(pts[:, :3], P, cfg.fov_left,
                                                      cfg.fov_right, valid)
        x_min, x_max = jv2._bbox((rows_f * scale).astype(jnp.int32), keep)
        y_min, y_max = jv2._bbox((cols_f * scale).astype(jnp.int32), keep)
        max_h = jnp.maximum(x_max - x_min + 1, out_h)
        max_w = jnp.maximum(y_max - y_min + 1, out_w)
        kf, ko = jax.random.split(jax.random.fold_in(k, 7))
        lo = jnp.asarray([max(0.0, 1.0 - s) for s in cfg.img_jitter], jnp.float32)
        hi = jnp.asarray([1.0 + s for s in cfg.img_jitter], jnp.float32)
        return (scale, jax.random.uniform(k_flip) < cfg.p_hflip,
                jax.random.uniform(k_rot, minval=-cfg.rot_deg, maxval=cfg.rot_deg)
                * jnp.pi / 180.0,
                jax.random.randint(k_top, (), 0, jnp.maximum(max_h - out_h, 0) + 1),
                jax.random.randint(k_left, (), 0, jnp.maximum(max_w - out_w, 0) + 1),
                jax.random.uniform(kf, (3,)) * (hi - lo) + lo, jax.random.permutation(ko, 3))

    draws = [draw(k, arrays[0][b], arrays[2][b], arrays[3][b])
             for b, k in enumerate(jax.random.split(key, B))]
    scale, flip, theta, top, left, factors, order = (
        torch.from_numpy(np.stack([np.asarray(d[i]) for d in draws])) for i in range(7))
    return tdata.V2AugParams(scale, flip, theta, top.long(), left.long(),
                             (factors, order.long()))


@pytest.mark.parametrize("train", [False, True])
def test_v2_batch_matches_jax_pallas_fill(samples, pallas_interpret, train):
    """`build_v2_batch` (K2's plain version, K1's for the flags) against
    pmf_tpu's `build_v2_batch` on its Pallas branch, at eval and in train
    with pmf_tpu's own draws (flip, rotation, scale, crop, ColorJitter):
    mask, labels and winner flags bit for bit, features within 1e-6; and the
    view's per-point geometry against `_v2_geometry`."""
    cfg_j = jv2.V2Config(**CFG, img_jitter=(0.4, 0.4, 0.4), fill="pallas")
    cfg_t = tdata.V2Config(**CFG, img_jitter=(0.4, 0.4, 0.4))
    key = jax.random.PRNGKey(5)
    aug = _jax_draws(key, samples, cfg_j, 3) if train else None
    want = jv2.build_v2_batch(key, *map(jnp.asarray, samples), cfg_j, train, return_points=True)
    ts = list(map(torch.from_numpy, samples))
    got = tdata.build_v2_batch(*ts, cfg_t, train, aug_override=aug, return_points=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert got[1].sum() > 300 and (got[2] > 0).sum() > 300

    geom = jax.jit(jax.vmap(lambda k, *a: jv2._v2_geometry(k, *a, cfg_j, train)))(
        jax.random.split(key, 3), *map(jnp.asarray, samples))
    mine = tdata.perspective_pipeline_v2.v2_view_geometry(*ts, cfg_t, train, aug_override=aug)
    for g, w in zip(mine[:5], geom[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(mine[5].numpy(), np.asarray(geom[5]), atol=1e-6)


def test_v2_train_view_draws_from_generator(samples):
    """A drawn view is reproduced by its generator's seed and differs with
    another seed; the train view without a generator raises."""
    cfg = tdata.V2Config(**CFG, img_jitter=(0.4, 0.4, 0.4))
    ts = list(map(torch.from_numpy, samples))
    draw = lambda seed: tdata.build_v2_batch(*ts, cfg, train=True,
                                             generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(4), draw(4), draw(5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3, 64, 128, 8) and a[1].sum() > 300
    with pytest.raises(ValueError):
        tdata.build_v2_batch(*ts, cfg, train=True)


def _per_scan(arrays, b, cfg_t, cfg_j):
    """Scan b through both per-scan paths: features within 1e-6; mask,
    labels, keep and depth bit for bit; rows and cols bit for bit where
    kept. (Under jit XLA contracts the projection's multiply-adds into
    FMAs, which the op-by-op order does not: the pixel of a point whose
    projection lies within an ulp of an integer can move by one. Every
    consumer masks the points not kept.)"""
    got = tdata.build_v2_eval_sample_with_uproj(*(torch.as_tensor(a[b]) for a in arrays), cfg_t)
    want = [np.asarray(w) for w in jv2.build_v2_eval_sample_with_uproj(
        *(jnp.asarray(a[b]) for a in arrays), cfg_j)]
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6)
    keep = want[5]
    np.testing.assert_array_equal(got[5].numpy(), keep)
    for i in (1, 2, 6):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    for i in (3, 4):
        np.testing.assert_array_equal(got[i].numpy()[keep], want[i][keep])
    return got


def test_v2_per_scan_matches_jax_scatter(samples):
    """`build_v2_eval_sample_with_uproj` (K1's plain version and a gather)
    against pmf_tpu's scatter path: mask, labels (truncated), rows, cols,
    keep and depth bit for bit, features within 1e-6."""
    for b in range(3):
        f, m, lab, rows, cols, keep, _ = _per_scan(samples, b, tdata.V2Config(**CFG),
                                                   jv2.V2Config(**CFG))
        assert f.shape == (64, 128, 8) and keep.sum() > 30
        assert m[rows[keep].long(), cols[keep].long()].all()


def test_v2_per_scan_131072_points_17_index_bits():
    """The per-scan path at the shipped config's 131072 points (17 index
    bits in K1's keys, depth clipped at 256 m) on a small image, with
    points past the clip and ties: the same as pmf_tpu's scatter path."""
    rng = np.random.default_rng(7)
    n = 131072
    pts = np.zeros((1, n, 4), np.float32)
    pts[..., 0] = rng.uniform(5, 450, n)
    pts[..., 1] = pts[..., 0] * rng.uniform(-0.7, 0.7, n)      # inside the yaw crop
    pts[..., 2] = pts[..., 0] * rng.uniform(-0.3, 0.3, n)
    pts[..., 3] = rng.random(n)
    pts[0, n // 2:n // 2 + 2000] = pts[0, :2000]                # ties at equal depth
    labels = rng.integers(0, 20, (1, n)).astype(np.int32)
    valid = np.ones((1, n), bool)
    valid[0, -100:] = False
    P = np.array([[[64, -80, 0, 0], [32, 0, -80, 0], [1, 0, 0, 0]]], np.float32)
    image = rng.random((1, 64, 160, 3)).astype(np.float32)
    arrays = [pts, labels, valid, P, image, np.array([60], np.int32), np.array([150], np.int32)]
    cfg = dict(CFG, n_points=n)
    f, m, *_, keep, depth = _per_scan(arrays, 0, tdata.V2Config(**cfg), jv2.V2Config(**cfg))
    assert keep.sum() > 100000 and (depth[keep] > 256).sum() > 10000 and m.sum() > 4000


@pytest.fixture(scope="module")
def epmf_port():
    return tmodels.random_weights(tmodels.EPMFNet(nclasses=20, base_channels=8), seed=0)


def _net_inputs(seed, h=64, w=128):
    rng = np.random.default_rng(seed)
    pcd = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    pcd[rng.random((2, h, w)) < 0.7] = 0                       # sparse, as the view gives it
    return pcd, rng.random((2, h, w, 3)).astype(np.float32)


def test_epmfnet_matches_flax(epmf_port):
    """Eval forward in float32: both streams' probabilities within 1e-4,
    argmax equal where the top-2 margin exceeds 1e-4."""
    params, stats = convert_pmf_state_dict(_numpy_sd(epmf_port))
    x = _net_inputs(1)
    lidar_j, cam_j = jax.jit(lambda v, a, b: jmodels.EPMFNet(nclasses=20, base_channels=8).apply(
        v, a, b, train=False))({"params": params, "batch_stats": stats}, *x)
    with torch.no_grad():
        lidar_t, cam_t = epmf_port(*map(torch.from_numpy, x))
    _check_probs(lidar_t, lidar_j)
    _check_probs(cam_t, cam_j)
    with pytest.raises(ValueError):
        epmf_port(torch.zeros(1, 48, 128, 5), torch.zeros(1, 48, 128, 3))


def test_epmfnet_bfloat16_convolutions_run_in_bfloat16(monkeypatch):
    """In bf16 every convolution gets a bf16 input, as in pmf_tpu (where
    the sparse convs' float32 outputs are cast back by the next conv or
    BN); the sparse convs still return float32."""
    model = tmodels.random_weights(tmodels.EPMFNet(nclasses=20, base_channels=8,
                                                   dtype=torch.bfloat16), seed=1)
    conv2d, seen = torch.nn.functional.conv2d, []

    def recording_conv2d(x, *args, **kwargs):
        seen.append(x.dtype)
        return conv2d(x, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording_conv2d)
    out = []
    model.lidar_stream.downCntx.conv1.register_forward_hook(lambda m, a, o: out.append(o[0].dtype))
    with torch.no_grad():
        lidar, cam = model(*map(torch.from_numpy, _net_inputs(2)))
    assert len(seen) == sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert set(seen) == {torch.bfloat16}
    assert out == [torch.float32]
    assert lidar.dtype == cam.dtype == torch.float32 and torch.isfinite(lidar).all()


def test_epmf_convert_round_trip_and_weight_files(epmf_port, tmp_path):
    """flax tree → port state_dict → flax tree: every leaf back bit for bit
    in the flax model's own structure (the extraUpSample names and the
    SparseVariantConv extra biases included); random_weights fills the
    extra biases; the .pth and .npz weight files give the same model, and a
    trainer snapshot's `mt_sigma` is left out."""
    flax_model = jmodels.EPMFNet(nclasses=20, base_channels=8)
    shapes = jax.eval_shape(lambda: flax_model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 128, 5)), jnp.zeros((1, 64, 128, 3))))
    params = random_flax_tree(shapes["params"], 3)
    stats = random_flax_tree(shapes["batch_stats"], 4)
    port = tmodels.EPMFNet(nclasses=20, base_channels=8)
    port.load_state_dict(tmodels.state_dict_from_flax(port, params, stats))
    back_p, back_s = convert_pmf_state_dict(_numpy_sd(port))
    for a, b in ((params, back_p), (stats, back_s)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y)
    extra = [m.bias for m in epmf_port.modules() if isinstance(m, tmodels.SparseVariantConv)]
    assert len(extra) == 9 and all(b.abs().min() > 0 for b in extra)

    pth, snapshot = str(tmp_path / "w.pth"), str(tmp_path / "snapshot.pth")
    torch.save(epmf_port.state_dict(), pth)
    torch.save({**epmf_port.state_dict(), "mt_sigma": torch.ones(6)}, snapshot)
    npz = save_flat_flax_npz(str(tmp_path / "w.npz"), epmf_port)
    for path in (pth, snapshot, npz):
        got = tmodels.load_weights(tmodels.EPMFNet(nclasses=20, base_channels=8), path)
        for k, v in epmf_port.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), (path, k)


def test_build_model_epmf_kitti():
    model = tmodels.build_model(load_options(EPMF_KITTI))
    assert isinstance(model, tmodels.EPMFNet) and model.dtype == torch.bfloat16
    assert model.lidar_stream.logits.in_channels == 32


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("epmf_cli")
    data = make_synthetic_kitti(str(root / "sequences"), n_scans=2, n_points=800)
    os.symlink(os.path.join(data, "00"), os.path.join(data, "08"))
    cfg = {
        "dataset": "SemanticKitti", "nclasses": 20, "data_root": data,
        "net_type": "EPMFNet", "base_channels": 8, "img_backbone": "resnet34",
        "compute_dtype": "float32", "batch_size": [1, 1],
        "PVconfig": {**CFG, "pcd_mean": [12.12, 10.88, 0.23, -1.04, 0.21],
                     "pcd_stds": [12.32, 11.47, 6.91, 0.86, 0.16]},
        "post": {"KNN": {"params": {"knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}},
    }
    path = str(root / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    model = tmodels.random_weights(tmodels.EPMFNet(nclasses=20, base_channels=8), seed=11)
    weights = str(root / "weights.pth")
    torch.save(model.state_dict(), weights)
    return {"root": root, "cfg": path, "weights": weights, "model": model}


def test_infer_cli_epmf_matches_jax(cli_setup):
    """The eval CLI's EPMF branch (the per-scan V2 view, EPMFNet, the KNN
    lift, pixel and point IoU) against pmf_tpu's Inference on the same
    weights: per-point predictions on >= 99.5 % of the points, mIoU within
    0.002."""
    from pmf_tpu.train.checkpoint import CheckpointManager

    s = cli_setup
    params, stats = convert_pmf_state_dict(_numpy_sd(s["model"]))
    ckpt = CheckpointManager(str(s["root"] / "ckpt"))
    ckpt.save_best({"params": params, "batch_stats": stats}, "IOU")
    template = jax.tree_util.tree_map(np.zeros_like, {"params": params, "batch_stats": stats})
    jax_preds = str(s["root"] / "preds_jax")
    build = jinfer.build_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinfer, "build_model", lambda opts: _TemplateInit(build(opts), template))
        jax_out = jinfer.Inference(jload_options(s["cfg"]),
                                   os.path.join(ckpt.directory, "best_IOU_model"),
                                   use_knn=True, save_preds=jax_preds).run()
    preds = str(s["root"] / "preds_torch")
    out = infer_kitti.main([s["cfg"], "--weights", s["weights"], "--knn", "--save-preds", preds,
                            "--device", "cpu"])
    got, want = _labels(preds), _labels(jax_preds)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (800,)
        assert (g == w).mean() >= 0.995
    for tag in ("pixel", "point"):
        assert abs(out[tag]["mIoU"] - jax_out[tag]["mIoU"]) <= 0.002
        assert np.isfinite(out[tag]["mIoU"])
