"""The port's A2D2 slice against pmf_tpu on the CPU: the adapter (points,
labels, undistorted images, pixel indices), the reader, the V2 view's
pixel-index branch (batched against pmf_tpu's Pallas branch in interpret
mode and per scan against its scatter path, eval and train with pmf_tpu's
own draws), the eval CLI (`A2D2Inference`, EPMFNet at a 64 x 96 window)
and the trainer's data (alpha, ignore, class names, view config) with one
debug `tools/train.py` run. The set is `tests/test_a2d2.py: _make_mini_a2d2`
(3 scans of 200 points, 96 x 128 images)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pmf_tpu.config import load_options as jload_options
from pmf_tpu.data import a2d2 as ja2d2
from pmf_tpu.data import loader as jloader
from pmf_tpu.data import perspective_pipeline_v2 as jv2
from pmf_tpu.models.torch_convert import convert_pmf_state_dict
from pmf_tpu.tools import infer_a2d2 as jinfer
from pmf_tpu.train import trainer as jtrainer
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch.config import load_options
from pmf_tpu_torch.data import a2d2 as ta2d2
from pmf_tpu_torch.tools import infer_a2d2
from pmf_tpu_torch.tools import train as train_cli
from pmf_tpu_torch.train import Trainer
from tests.test_a2d2 import _make_mini_a2d2
from tests.test_torch_epmf import pallas_interpret  # noqa: F401 (a fixture)
from tests.test_torch_infer_kitti import _TemplateInit
from tests.test_torch_models import _numpy_sd

PIX_KEYS = ("points", "labels", "valid", "rows", "cols", "image", "img_h", "img_w")
CFG = dict(canvas_h=96, canvas_w=128, proj_h=64, proj_w=96, proj_ht=64, proj_wt=96,
           n_points=512, img_mean=(17.95, 16.17, -0.17, 1.23, 18.49),
           img_stds=(24.0, 23.55, 8.06, 3.96, 21.45))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several test processes side by
    side on the cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _make_mini_a2d2(str(tmp_path_factory.mktemp("a2d2_torch")))


def _datasets(root, split="train", excludes=False):
    paths = [os.path.join(root, "cams_lidars.json"), os.path.join(root, "class_index.json")]
    return (ta2d2.A2D2_PV(root, *paths, split=split, apply_excludes=excludes),
            ja2d2.A2D2_PV(root, *paths, split=split, apply_excludes=excludes))


def test_adapter_matches_jax(root):
    """File lists, points, labels, undistorted images, pixel indices and
    save names exactly; the two undistortion models on a distorted camera."""
    t, j = _datasets(root)
    assert len(t) == len(j) == 3 and len(_datasets(root, "valid")[0]) == 0
    for attr in ("lidar_files", "camera_files", "label_files"):
        assert getattr(t, attr) == getattr(j, attr)
    np.testing.assert_array_equal(t.cls_freq, j.cls_freq)
    assert t.mapped_cls_name == j.mapped_cls_name and len(t.mapped_cls_name) == 39
    for i in range(3):
        for a, b in zip(t.loadDataByIndex(i), j.loadDataByIndex(i)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t.pixel_indices(i), j.pixel_indices(i)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.loadImage(i), j.loadImage(i))
        assert t.get_save_file_name(t.label_files[i]) == j.get_save_file_name(j.label_files[i])
    assert set(np.unique(t.loadDataByIndex(0)[1])) <= {1, 27, 34, 35}
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    K = np.array([[40.0, 0, 31.5], [0, 42.0, 23.5], [0, 0, 1]])
    for lens, dist in (("Telecam", [0.2, -0.05, 0.01, 0.02, 0.01]),
                       ("Fisheye", [0.05, 0.01, -0.002, 0.001])):
        got = ta2d2.undistort_image(img, K, np.array(dist), K * 1.1, lens)
        np.testing.assert_array_equal(got, ja2d2.undistort_image(img, K, np.array(dist),
                                                                 K * 1.1, lens))
        assert (got != img).any()


@pytest.fixture(scope="module")
def samples(root):
    """The reader's three scans, stacked in PIX_KEYS order (after holding
    each dict to pmf_tpu's reader)."""
    t, j = _datasets(root)
    read_t = tdata.a2d2_sample_reader(t, tdata.V2Config(**CFG))
    read_j = jloader.a2d2_sample_reader(j, jv2.V2Config(**CFG))
    scans = []
    for i in range(3):
        got, want = read_t(i), read_j(i)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        scans.append(got)
    return [np.stack([np.asarray(s[k]) for s in scans]) for k in PIX_KEYS]


def test_reader_pads_the_pixels(samples):
    points, labels, valid, rows, cols, image = samples[:6]
    assert valid.sum(1).tolist() == [200] * 3 and (rows[~valid] == 0).all()
    assert rows[valid].max() <= 95 and cols[valid].max() <= 127
    assert image.max() <= 1 / 255 + 1e-9        # divided by 255 twice, as pmf_tpu's reader


def _jax_pix_draws(key, arrays, cfg, B):
    """pmf_tpu's train-view draws on the pixel-index branch, made from `key`
    as `build_v2_batch_pix` and `_v2_geometry` make them, under jit as they
    run: scale, flip, theta, top, left and the ColorJitter."""
    out_h, out_w = cfg.proj_ht, cfg.proj_wt

    @jax.jit
    def draw(k, valid, rows, cols):
        _, k_scale, k_flip, k_rot, k_top, k_left = jax.random.split(k, 6)
        scale = jax.random.uniform(k_scale, minval=cfg.scale_min, maxval=cfg.scale_max)
        x_min, x_max = jv2._bbox((rows.astype(jnp.float32) * scale).astype(jnp.int32), valid)
        y_min, y_max = jv2._bbox((cols.astype(jnp.float32) * scale).astype(jnp.int32), valid)
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

    draws = [draw(k, arrays[2][b], arrays[3][b], arrays[4][b])
             for b, k in enumerate(jax.random.split(key, B))]
    scale, flip, theta, top, left, factors, order = (
        torch.from_numpy(np.stack([np.asarray(d[i]) for d in draws])) for i in range(7))
    return tdata.V2AugParams(scale, flip, theta, top.long(), left.long(),
                             (factors, order.long()))


@pytest.mark.parametrize("fill", ["pallas", "scatter"])
@pytest.mark.parametrize("train", [False, True])
def test_pix_view_matches_jax(samples, pallas_interpret, fill, train):  # noqa: F811
    """`build_v2_batch_pix` (K2's plain version, K1's for the winner flags)
    against pmf_tpu's `build_v2_batch_pix` on its Pallas branch (batched)
    and its scatter path (per scan), at eval and in train with pmf_tpu's
    draws: mask, labels and winner flags bit for bit, features within 1e-6;
    and the per-point geometry (the tight box over every valid point)
    against `_v2_geometry(pix=)` bit for bit."""
    cfg_j = jv2.V2Config(**CFG, img_jitter=(0.4, 0.4, 0.4), fill=fill)
    cfg_t = tdata.V2Config(**CFG, img_jitter=(0.4, 0.4, 0.4))
    key = jax.random.PRNGKey(11)
    aug = _jax_pix_draws(key, samples, cfg_j, 3) if train else None
    ja = list(map(jnp.asarray, samples))
    want = jv2.build_v2_batch_pix(key, *ja, cfg_j, train, return_points=True)
    ts = list(map(torch.from_numpy, samples))
    got = tdata.build_v2_batch_pix(*ts, cfg_t, train, aug_override=aug, return_points=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert got[1].sum() > 200 and (got[2] > 0).sum() > 200
    if fill == "pallas":
        return      # the geometry before the fill is the same on both branches
    geom = jax.jit(jax.vmap(lambda k, *a: jv2._v2_geometry(
        k, *a[:3], jnp.zeros((3, 4)), *a[5:], cfg_j, train, pix=(a[3], a[4]))))(
        jax.random.split(key, 3), *ja)
    mine = tdata.perspective_pipeline_v2.v2_view_geometry(
        *ts[:3], None, *ts[5:], cfg_t, train, aug_override=aug, pix=(ts[3], ts[4]))
    for g, w in zip(mine[:5], geom[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(mine[5].numpy(), np.asarray(geom[5]), atol=1e-6)
    if not train:   # eval: the centre crop of the 95 x 127 box keeps part of each scan
        assert 0 < mine[2].sum() < ts[2].sum()


class _Restore:
    """pmf_tpu's CheckpointManager(directory) with `variables` held in
    memory: `restore_weights` returns them after checking that the model's
    template has their structure (the tests compare the CLIs, not orbax's
    save and restore)."""

    def __init__(self, variables):
        self.variables = variables

    def __call__(self, directory):
        return self

    def restore_weights(self, path, template):
        assert jax.tree_util.tree_structure(template) == \
            jax.tree_util.tree_structure(self.variables)
        return self.variables


def jax_cli_weights(mp, module, model, build_name: str):
    """Give pmf_tpu's CLI `module` the port `model`'s weights, converted:
    its `build_name` (the net's constructor there) builds the net with a
    template init (`_TemplateInit`) and its CheckpointManager restores the
    weights (`_Restore`)."""
    params, stats = convert_pmf_state_dict(_numpy_sd(model))
    variables = {"params": params, "batch_stats": stats}
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    build = getattr(module, build_name)
    mp.setattr(module, build_name, lambda *a, **k: _TemplateInit(build(*a, **k), template))
    mp.setattr(module, "CheckpointManager", _Restore(variables))


def _config(root, tmp_path, **kw):
    cfg = {"save_path": str(tmp_path / "exp"), "seed": 1, "n_epochs": 1, "batch_size": [2, 2],
           "lr": 0.001, "warmup_epochs": 1, "dataset": "a2d2", "nclasses": 39,
           "data_root": root, "apply_excludes": False, "net_type": "EPMFNet",
           "base_channels": 8, "img_backbone": "resnet34", "compute_dtype": "float32",
           "experiment_id": "a2d2", "use_mtloss": True, "point_lovasz": False,
           "cls_freq": [0] + [1000 * (i % 7 + 1) for i in range(38)],
           "PVconfig": {"canvas_h": 96, "canvas_w": 128, "proj_h": 64, "proj_w": 96,
                        "proj_ht": 64, "proj_wt": 96, "n_points": 512,
                        "pcd_mean": list(CFG["img_mean"]), "pcd_stds": list(CFG["img_stds"])},
           "augmentation": {"img_jitter": [0.4, 0.4, 0.4]}, **kw}
    path = str(tmp_path / "a2d2.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_infer_cli_matches_jax(root, tmp_path):
    """`infer_a2d2` (the centred window, K1's plain version, EPMFNet at
    64 x 96, a size that is a multiple of 32 and not of 64, the gather)
    against pmf_tpu's A2D2Inference on the same weights: the `.label`
    files agree on >= 99.5 % of the points, mIoU within 0.002."""
    cfg = _config(root, tmp_path)
    model = tmodels.random_weights(tmodels.EPMFNet(nclasses=39, base_channels=8), seed=5)
    weights = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), weights)
    jax_preds, preds = str(tmp_path / "preds_jax"), str(tmp_path / "preds")
    with pytest.MonkeyPatch.context() as mp:
        jax_cli_weights(mp, jinfer, model, "build_model")
        want = jinfer.A2D2Inference(jload_options(cfg), "weights", save_preds=jax_preds,
                                    split="train").run()
    got = infer_a2d2.main([cfg, "--weights", weights, "--save-preds", preds, "--split", "train",
                           "--device", "cpu"])
    names = sorted(os.listdir(jax_preds))
    assert names == sorted(os.listdir(preds)) and len(names) == 3
    assert all(n.endswith(".label") and "pred" in n for n in names)
    for n in names:
        g, w = (np.fromfile(os.path.join(d, n), np.int32) for d in (preds, jax_preds))
        assert g.shape == w.shape == (200,)
        assert (g == w).mean() >= 0.995
        assert 20 < (g > 0).sum() < 200 and len(np.unique(g)) > 2
    assert abs(got["mIoU"] - want["mIoU"]) <= 0.002 and np.isfinite(got["mIoU"])


def _jax_trainer_data(monkeypatch, cfg):
    """pmf_tpu's Trainer data set-up for `cfg`, stopped before its loaders."""
    class _Stop(Exception):
        pass

    def stop(*a, **k):
        raise _Stop

    trainer = jtrainer.Trainer.__new__(jtrainer.Trainer)
    trainer.opts = jload_options(cfg)
    trainer.mesh = type("Mesh", (), {"shape": {"data": 1}})()
    monkeypatch.setattr(jtrainer, "HostLoader", stop)
    with pytest.raises(_Stop):
        trainer._init_data()
    return trainer


def test_trainer_data_matches_jax(root, tmp_path, monkeypatch):
    """`Trainer.from_files` on A2D2: alpha from `cls_freq`, class 0 ignored,
    the class names, the V2 view's config (canvas 1208 x 1920 unless set)
    and the validation set falling back to the train split, as pmf_tpu's
    trainer sets them up."""
    cfg = _config(root, tmp_path)
    want = _jax_trainer_data(monkeypatch, cfg)
    opts = load_options(cfg)
    trainer = Trainer.from_files(opts, tmodels.EPMFNet(nclasses=39, base_channels=8),
                                 torch.device("cpu"))
    np.testing.assert_array_equal(np.asarray(trainer.loss_cfg.alpha, np.float32), want.alpha)
    assert trainer.metrics.ignore == want.ignore_class == [0]
    assert trainer.class_names == want.mapped_cls_name
    as_value = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    for field in dataclasses.fields(tdata.V2Config):
        assert as_value(getattr(trainer.view_cfg, field.name)) == \
            as_value(getattr(want.v2_cfg, field.name)), field.name
    assert trainer.loaders["Validation"].n_samples == want._val_len == 3
    assert trainer.view_keys == PIX_KEYS and not trainer.point_lovasz
    del opts.config["PVconfig"]["canvas_h"], opts.config["PVconfig"]["canvas_w"]
    assert (tdata.v2_config(opts).canvas_h, tdata.v2_config(opts).canvas_w) == (1208, 1920)


def test_train_cli_debug_then_infer(root, tmp_path):
    """One debug `tools/train.py` run on A2D2 (EPMFNet, multi-task loss,
    image-domain Lovász): finite losses, and its snapshot loads in
    `infer_a2d2`."""
    cfg = _config(root, tmp_path, is_debug=True)
    best = train_cli.main([cfg, "--device", "cpu"])
    assert np.isfinite(best["IOU"])
    run_dir = load_options(cfg).run_dir
    out = infer_a2d2.main([cfg, "--weights", os.path.join(run_dir, "checkpoint",
                                                          "best_last_model.pth"),
                           "--split", "train", "--max-scans", "1", "--device", "cpu"])
    assert np.isfinite(out["mIoU"])
