"""The port's nuScenes slice against pmf_tpu on the CPU: the adapters and
their split, both readers, PMF's "cam" view and the V2 view in the camera
frame with each camera's field of view, the six-camera eval CLI (PMF and
EPMF, with and without KNN), the submission merge and its check, SalsaNext's
nuScenes predictions, the Trainer's nuScenes data and the three nuScenes
configs through the train CLI; and the conv init of pmf_tpu (C1). The DB is
`_make_mini_nuscenes`' (tests/test_nuscenes.py), its three keyframes split
into two scenes that the devkit's mini split names: keyframe 0 trains,
keyframes 1 and 2 validate."""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pmf_tpu import data as jdata
from pmf_tpu.config import load_options as jload_options
from pmf_tpu.data import nuscenes as jnusc
from pmf_tpu.data import perspective_pipeline as jpp
from pmf_tpu.data import perspective_pipeline_v2 as jv2
from pmf_tpu.models.torch_convert import convert_generic_state_dict, convert_pmf_state_dict
from pmf_tpu.ops import scatter as jscatter
from pmf_tpu.ops.pallas import tile_fill
from pmf_tpu.tools import infer_nuscenes as jinfer
from pmf_tpu.tools import infer_salsanext as jinfer_salsanext
from pmf_tpu.tools import merge_nuscenes_submission as jmerge
from pmf_tpu.train import trainer as jtrainer
from pmf_tpu.train.checkpoint import CheckpointManager
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch.config import load_options
from pmf_tpu_torch.data import nuscenes as tnusc
from pmf_tpu_torch.models.layers import LECUN_TRUNC
from pmf_tpu_torch.tools import infer_nuscenes, infer_salsanext, merge_nuscenes_submission
from pmf_tpu_torch.tools import train as train_cli
from pmf_tpu_torch.train import Trainer
from tests.test_nuscenes import _make_mini_nuscenes
from tests.test_torch_infer_kitti import _TemplateInit
from tests.test_torch_models import _numpy_sd

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs", "experiments")
VIEW_KEYS = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
N_POINTS = 4096
SENSOR = dict(canvas_h=224, canvas_w=400, proj_h=64, proj_w=128, proj_ht=64, proj_wt=128,
              n_points=N_POINTS)
VIEW = dict(SENSOR, proj_h=224, proj_w=400, proj_ht=128, proj_wt=256)   # the whole image
MEAN, STDS = [12.12, 10.88, 0.23, -1.04, 0.21], [12.32, 11.47, 6.91, 0.86, 0.16]
KNN = {"KNN": {"params": {"knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several test processes side by
    side on the cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quat(rot) -> list:
    """[w, x, y, z] of a scipy Rotation."""
    q = rot.as_quat()
    return [float(q[3]), float(q[0]), float(q[1]), float(q[2])]


@pytest.fixture(scope="module")
def nusc(tmp_path_factory):
    """The fixture's DB with 4000 points a scan, keyframe 0 in scene-0061
    (mini train) and keyframes 1, 2 in scene-0103 (mini val); v1.0-trainval
    links to it. Its poses are made a vehicle's: the lidar and the ego poses
    turned by small random yaws, each camera looking out horizontally along
    its yaw i · 60° (camera z forward, x right, y down), so that each sees
    some hundred points (the fixture's random rotations leave most cameras
    none)."""
    from scipy.spatial.transform import Rotation as R

    root = _make_mini_nuscenes(str(tmp_path_factory.mktemp("nusc")), n_samples=3,
                               n_points=4000)
    tdir = os.path.join(root, "v1.0-mini")
    tables = {n: json.load(open(os.path.join(tdir, f"{n}.json")))
              for n in ("scene", "sample", "calibrated_sensor", "ego_pose")}
    rng = np.random.default_rng(11)
    for rec in tables["ego_pose"]:
        rec["rotation"] = _quat(R.from_euler("z", rng.uniform(-0.1, 0.1)))
    cam_axes = R.from_matrix([[0, 0, 1], [-1, 0, 0], [0, -1, 0]])   # camera → vehicle axes
    for rec in tables["calibrated_sensor"]:
        if rec["token"].startswith("lcs"):
            rec["rotation"] = _quat(R.from_euler("z", rng.uniform(-0.1, 0.1)))
        else:
            cam = int(rec["token"].split("_")[1])
            rec["rotation"] = _quat(R.from_euler("z", cam * np.pi / 3) * cam_axes)
    tables["scene"][0]["name"] = "scene-0061"
    tables["scene"].append({"token": "scene1", "name": "scene-0103",
                            "first_sample_token": "samp1"})
    for s in tables["sample"][1:]:
        s["scene_token"] = "scene1"
    for name, rows in tables.items():
        with open(os.path.join(tdir, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    os.symlink(tdir, os.path.join(root, "v1.0-trainval"))
    return root


@pytest.fixture(scope="module")
def nusc_front(nusc, tmp_path_factory):
    """`nusc` with each scan's points moved in front of the lidar (x in 6-30
    m, |y| < 0.9 x), so that pmf_tpu's EPMF view, which crops every camera
    by the lidar frame's ±45° (ROADMAP C6), keeps a compact tight box for
    the cameras facing front and back and covers a third of the points."""
    root = str(tmp_path_factory.mktemp("nusc_front") / "db")
    shutil.copytree(nusc, root)
    rng = np.random.default_rng(12)
    lidar = os.path.join(root, "samples", "LIDAR_TOP")
    for name in sorted(os.listdir(lidar)):
        pts = np.fromfile(os.path.join(lidar, name), np.float32).reshape(-1, 5)
        pts[:, 0] = rng.uniform(6, 30, len(pts))
        pts[:, 1] = pts[:, 0] * rng.uniform(-0.9, 0.9, len(pts))
        pts.tofile(os.path.join(lidar, name))
    return root


@pytest.fixture
def pallas_interpret(monkeypatch):
    """pmf_tpu's tile rasterizer in interpret mode, as its own tests run it
    on the CPU."""
    orig = tile_fill.rasterize_zbuffer_pallas
    monkeypatch.setattr(tile_fill, "rasterize_zbuffer_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("version,split,has_image,v2", [
    ("v1.0-mini", "train", True, False), ("v1.0-mini", "val", True, True),
    ("v1.0-trainval", "val", False, False), ("v1.0-mini", "test", True, True)])
def test_adapters_match_jax(nusc, version, split, has_image, v2):
    """`Nuscenes` and `NuscenesV2` against pmf_tpu's on the same DB: token
    lists, the class LUT and names, points, labels, images, the composed
    projection and the camera transform exactly; fov and image scale."""
    cls = (tnusc.NuscenesV2, jnusc.NuscenesV2) if v2 else (tnusc.Nuscenes, jnusc.Nuscenes)
    got, want = (c(nusc, version=version, split=split, has_image=has_image) for c in cls)
    assert got.token_list == want.token_list and len(got) == (6 if has_image else 1) * \
        (1 if split in ("train", "test") else 2)
    _equal(got.class_map_lut, want.class_map_lut)
    assert got.mapped_cls_name == want.mapped_cls_name
    for i in range(len(got)):
        assert got.lidar_token(i) == want.lidar_token(i)
        assert got.parsePathInfoByIndex(i) == want.parsePathInfoByIndex(i)
        for a, b in zip(got.loadDataByIndex(i), want.loadDataByIndex(i)):
            _equal(a, b)
        _equal(got.labelMapping(got.loadDataByIndex(i)[1]),
               want.labelMapping(want.loadDataByIndex(i)[1]))
        if not has_image:
            continue
        _equal(got.projection_matrix(i), want.projection_matrix(i))
        if i < 7:
            _equal(got.loadImage(i), want.loadImage(i))
        if v2:
            assert got.cam_channel(i) == want.cam_channel(i)
            assert got.fov(i) == want.fov(i) and got.image_scale(i) == want.image_scale(i)
            for a, b in zip(got.camera_transform(i), want.camera_transform(i)):
                _equal(a, b)
    if split != "test":
        _equal(got.loadLabelByIndex(0)[0], want.loadLabelByIndex(0)[0])
        assert got.loadDataByIndex(0)[1].any()
    with pytest.raises(TypeError):
        got.projection_matrix("token")


@pytest.mark.parametrize("case", ["mini", "trainval", "names", "splits_file", "val_overlap"])
def test_split_resolution_matches_jax(tmp_path, case):
    """`_resolve_train_scenes`: the mini split, trainval as the complement of
    the official val split, explicit names, a splits file, and a splits file
    whose train list meets the val split of a DB that holds all of it,
    which raises in both."""
    names = tnusc.VAL_SCENES + ["scene-0061", "scene-0553", "scene-9999"]
    by_name = {n: f"tok-{n}" for n in names}
    splits = str(tmp_path / "splits.json")
    train = ["scene-0061", "scene-0003"] if case == "val_overlap" else ["scene-0061"]
    with open(splits, "w") as f:
        json.dump({"train": train}, f)
    args = {"mini": ("v1.0-mini", by_name, None, None),
            "trainval": ("v1.0-trainval", by_name, None, None),
            "names": ("v1.0-trainval", by_name, ["scene-0553"], splits),
            "splits_file": ("v1.0-mini", by_name, None, splits),
            "val_overlap": ("v1.0-trainval", by_name, None, splits)}[case]
    if case == "val_overlap":
        for mod in (tnusc, jnusc):
            with pytest.raises(ValueError, match="intersects the official val"):
                mod._resolve_train_scenes(*args)
        return
    got = tnusc._resolve_train_scenes(*args)
    assert got == jnusc._resolve_train_scenes(*args) and got
    if case == "trainval":
        assert got == ["scene-0061", "scene-9999"]   # scene-0553 is also a val scene
    assert tnusc.MINI_TRAIN == jnusc.MINI_TRAIN and tnusc.MINI_VAL == jnusc.MINI_VAL
    assert tnusc.GENERAL_TO_SEG_CLASS == jnusc.GENERAL_TO_SEG_CLASS
    assert tnusc.SEG_CLASS_TO_INDEX == jnusc.SEG_CLASS_TO_INDEX
    assert tnusc.FOV_ANGLE_V2 == jnusc.FOV_ANGLE_V2 and tnusc.CAMERAS == jnusc.CAMERAS


def _read_all(reader, n):
    samples = [reader(i) for i in range(n)]
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in samples[0]}


@pytest.fixture(scope="module")
def cam_samples(nusc):
    """The val keyframes' 12 items through both packages' nuScenes readers
    (PMF's and the V2 camera-frame one), held equal, stacked."""
    out = {}
    for name, (tds, jds, tread, jread) in {
            "pmf": (tnusc.Nuscenes, jnusc.Nuscenes, tdata.nuscenes_sample_reader,
                    jdata.nuscenes_sample_reader),
            "v2": (tnusc.NuscenesV2, jnusc.NuscenesV2, tdata.nuscenes_v2_sample_reader,
                   jdata.nuscenes_v2_sample_reader)}.items():
        cfg = tdata.PVConfig(**SENSOR)
        got = _read_all(tread(tds(nusc, version="v1.0-mini", split="val"), cfg), 12)
        want = _read_all(jread(jds(nusc, version="v1.0-mini", split="val"), cfg), 12)
        assert got.keys() == want.keys()
        for k in got:
            _equal(got[k], want[k])
        out[name] = got
    return out


def test_readers_match_jax(cam_samples):
    """Both readers' sample dicts equal pmf_tpu's (checked in the fixture);
    the V2 reader's scans are in the camera frame, its matrix [K' | 0] and
    its fov the camera's."""
    v2 = cam_samples["v2"]
    assert (v2["proj_matrix"][:, :, 3] == 0).all()
    np.testing.assert_allclose(v2["fov"][0], np.deg2rad([-35, 35]), rtol=1e-6)
    assert v2["img_w"][0] == 240 and v2["img_w"][3] == 400      # CAM_BACK keeps its size
    assert cam_samples["pmf"]["valid"].sum(1).min() == 4000


def _held_where_kept(got, want):
    """(rows, cols, keep, ...) of the port against pmf_tpu's: keep and the
    rest bit for bit, rows and cols where kept. (Points projected past 2^24
    px get other integer coordinates under jit than op by op, in pmf_tpu
    itself (ROADMAP C4); every consumer masks them by keep.)"""
    keep = np.asarray(want[2])
    _equal(got[2], keep)
    for g, w in zip(got[:2], want[:2]):
        _equal(np.asarray(g)[keep], np.asarray(w)[keep])
    for g, w in zip(got[3:], want[3:]):
        _equal(g, w)


def _cam_cfgs(**kw):
    return (tdata.PVConfig(**VIEW, h_pad=0, w_pad=0, projection="cam", **kw),
            jpp.PVConfig(**VIEW, h_pad=0, w_pad=0, projection="cam", **kw))


def _arrays(samples, idx):
    return [samples[k][idx] for k in VIEW_KEYS]


@pytest.mark.parametrize("train", [False, True])
def test_cam_view_batched_matches_jax(cam_samples, pallas_interpret, train):
    """PMF's "cam" view of 6 items batched, at eval against pmf_tpu's
    `build_batch` on its Pallas branch, in train (flip, rotation, crop drawn
    by pmf_tpu under jit) against its per-scan view with those draws: the
    view's integers and depths bit for bit, mask, labels and winner flags
    bit for bit, features within 1e-6."""
    cfg_t, cfg_j = _cam_cfgs()
    arrays = _arrays(cam_samples["pmf"], slice(0, 6))
    ts = list(map(torch.from_numpy, arrays))
    if not train:
        got = tdata.build_batch(*ts, cfg_t, return_points=True)
        want = jpp.build_batch(jax.random.PRNGKey(0), *map(jnp.asarray, arrays),
                               dataclasses.replace(cfg_j, fill="pallas"), False,
                               return_points=True)
        want = [*want[:3], *want[3][::2]]
    else:
        keys = jax.random.split(jax.random.PRNGKey(3), 6)
        draw = jax.jit(lambda k, h, w: jpp._affine_params(k, h, w, cfg_j, True))
        draws = [draw(keys[b], arrays[5][b], arrays[6][b]) for b in range(6)]
        flip, theta, top, left = (np.stack([np.asarray(d[i]) for d in draws]) for i in range(4))
        aug = tdata.AugParams(*map(torch.from_numpy, (flip, theta, top.astype(np.int64),
                                                      left.astype(np.int64))))
        got = tdata.build_batch(*ts, cfg_t, train=True, aug_override=aug, return_points=True)
        view = jax.jit(lambda *a: jpp._build_view(None, *a[:7], cfg_j, True, aug_override=a[7:]))
        outs = []
        for b in range(6):
            f, m, lab, rows, cols, keep, depth = view(*(a[b] for a in arrays), flip[b],
                                                      theta[b], top[b], left[b])
            pix, won = jscatter.point_winner_flags(rows, cols, depth, keep, cfg_j.proj_ht,
                                                   cfg_j.proj_wt)
            outs.append([jpp.normalize_feature(f, m, cfg_j), m, lab, pix, won])
        want = [np.stack([np.asarray(o[i]) for o in outs]) for i in range(5)]
    for g, w in zip([*got[:3], got[3][0], got[3][2]][1:], want[1:]):
        _equal(g, w)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    _equal(got[0][..., 5:], np.asarray(want[0])[..., 5:])
    assert got[1].sum() > 100

    # the view's per-point geometry against `_view_geometry`, under jit as it
    # runs: keep, depth and values bit for bit, rows and cols where kept
    geom = tdata.perspective_pipeline.view_geometry(*ts, cfg_t, aug if train else None)
    jgeom = jax.jit(lambda *a: jpp._view_geometry(jax.random.PRNGKey(0), *a[:7], cfg_j, train,
                                                  aug_override=a[7:] if train else None))
    for b in range(6):
        extra = (flip[b], theta[b], top[b], left[b]) if train else ()
        _held_where_kept([g[b] for g in geom[:5]], jgeom(*(a[b] for a in arrays), *extra)[:5])


def test_cam_view_per_scan_matches_jax(cam_samples):
    """The per-scan "cam" eval view (K1's plain version and a gather)
    against pmf_tpu's scatter path: every output bit for bit but the
    features, within 1e-6."""
    cfg_t, cfg_j = _cam_cfgs()
    arrays = _arrays(cam_samples["pmf"], slice(None))
    kept = 0
    for b in (0, 2, 4, 7, 9, 11):
        got = tdata.build_eval_sample_with_uproj(*(torch.as_tensor(a[b]) for a in arrays), cfg_t)
        want = jpp.build_eval_sample_with_uproj(*(jnp.asarray(a[b]) for a in arrays), cfg_j)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
        _equal(got[1], want[1])
        _equal(got[2], want[2])
        _held_where_kept(got[3:], want[3:])
        kept += int(got[5].sum())
    assert kept > 100


def _jax_v2_draws(key, arrays, fovs, cfg):
    """pmf_tpu's train draws of the camera-frame V2 view for each item,
    made from `key` as `build_v2_batch` and `_v2_geometry` make them, under
    jit: scale, flip, theta, top, left."""
    out_h, out_w = cfg.proj_ht, cfg.proj_wt

    @jax.jit
    def draw(k, pts, valid, P, fov):
        _, k_scale, k_flip, k_rot, k_top, k_left = jax.random.split(k, 6)
        scale = jax.random.uniform(k_scale, minval=cfg.scale_min, maxval=cfg.scale_max)
        xyz = pts[:, :3]
        keep = (xyz[:, 2] > cfg.min_depth_cam) & valid
        yaw = -jnp.arctan2(xyz[:, 2], xyz[:, 0])
        keep &= (yaw >= fov[0] - jnp.pi / 2.0) & (yaw <= fov[1] - jnp.pi / 2.0)
        uvw = (xyz[:, :, None] * P.T[None, :3, :]).sum(1) + P.T[3]
        w = jnp.where(jnp.abs(uvw[:, 2]) > 1e-9, uvw[:, 2], 1e-9)
        x_min, x_max = jv2._bbox((uvw[:, 1] / w * scale).astype(jnp.int32), keep)
        y_min, y_max = jv2._bbox((uvw[:, 0] / w * scale).astype(jnp.int32), keep)
        max_h = jnp.maximum(x_max - x_min + 1, out_h)
        max_w = jnp.maximum(y_max - y_min + 1, out_w)
        return (scale, jax.random.uniform(k_flip) < cfg.p_hflip,
                jax.random.uniform(k_rot, minval=-cfg.rot_deg, maxval=cfg.rot_deg)
                * jnp.pi / 180.0,
                jax.random.randint(k_top, (), 0, jnp.maximum(max_h - out_h, 0) + 1),
                jax.random.randint(k_left, (), 0, jnp.maximum(max_w - out_w, 0) + 1))

    B = arrays[0].shape[0]
    draws = [draw(k, arrays[0][b], arrays[2][b], arrays[3][b], fovs[b])
             for b, k in enumerate(jax.random.split(key, B))]
    scale, flip, theta, top, left = (
        torch.from_numpy(np.stack([np.asarray(d[i]) for d in draws])) for i in range(5))
    return tdata.V2AugParams(scale, flip, theta, top.long(), left.long())


@pytest.mark.parametrize("train", [False, True])
def test_cam_frame_v2_view_with_fovs_matches_jax(cam_samples, pallas_interpret, train):
    """The V2 view of NuscenesV2's camera-frame items with each camera's
    `fovs`, batched against pmf_tpu's Pallas branch (train: with its draws
    under jit), and at eval per scan (the config's pair) against its
    scatter path: mask, labels and winner flags bit for bit, features within
    1e-6 (the train view's bilinear RGB 2e-5, PERF.md §2)."""
    cfg = dict(VIEW, proj_ht=64, proj_wt=128)
    cfg_t = tdata.V2Config(**cfg, cam_frame=True)
    cfg_j = jv2.V2Config(**cfg, cam_frame=True, fill="pallas")
    v2 = cam_samples["v2"]
    arrays = _arrays(v2, slice(0, 6))
    key = jax.random.PRNGKey(7)
    aug = _jax_v2_draws(key, arrays, v2["fov"][:6], cfg_j) if train else None
    want = jv2.build_v2_batch(key, *map(jnp.asarray, arrays), cfg_j, train,
                              fovs=jnp.asarray(v2["fov"][:6]), return_points=True)
    got = tdata.build_v2_batch(*map(torch.from_numpy, arrays), cfg_t, train, aug_override=aug,
                               return_points=True, fovs=torch.from_numpy(v2["fov"][:6]))
    for g, w in zip([got[1], got[2], *got[3]], [want[1], want[2], *want[3]]):
        _equal(g, w)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5 if train else 1e-6)
    assert got[1].sum() > 100
    # the config's own pair differs from the cameras': a default-fov view keeps other points
    other = tdata.build_v2_batch(*map(torch.from_numpy, arrays), cfg_t, train, aug_override=aug)
    assert not torch.equal(other[1], got[1])
    if train:
        return
    for b in range(0, 12, 5):       # per scan, with the config's pair
        one = [torch.as_tensor(v2[k][b]) for k in VIEW_KEYS]
        g = tdata.build_v2_eval_sample_with_uproj(*one, cfg_t)
        w = jv2.build_v2_eval_sample_with_uproj(*(jnp.asarray(t.numpy()) for t in one),
                                                jv2.V2Config(**cfg, cam_frame=True))
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]), atol=1e-6)
        _equal(g[1], w[1])
        _equal(g[2], w[2])
        _held_where_kept(g[3:], w[3:])


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


def test_view_configs_match_jax(monkeypatch):
    """The shipped nuScenes configs: `pv_config` and `v2_config` against the
    PVConfig/V2Config that pmf_tpu's trainer builds from them (stopped
    before it reads a dataset), `eval_view_config` against its eval CLI's
    (stopped likewise)."""
    as_value = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    for name, field in (("pmf_nuscenes.yaml", "pv_cfg"), ("epmf_nuscenes.yaml", "v2_cfg")):
        path = os.path.join(CONFIGS, name)
        trainer = jtrainer.Trainer.__new__(jtrainer.Trainer)
        trainer.opts = jload_options(path)
        monkeypatch.setattr(jtrainer, "Nuscenes",
                            lambda *a, **k: type("Dataset", (), {"mapped_cls_name": {}})())
        monkeypatch.setattr(jtrainer, "nuscenes_sample_reader", _stop)
        with pytest.raises(_Stop):
            trainer._init_data()
        got = tdata.view_config(load_options(path))
        want = getattr(trainer, field)
        for f in dataclasses.fields(got):
            assert as_value(getattr(got, f.name)) == as_value(getattr(want, f.name)), f.name

        inf = jinfer.NuscenesInference.__new__(jinfer.NuscenesInference)
        monkeypatch.setattr(jinfer, "Nuscenes", _stop)
        with pytest.raises(_Stop):
            inf.__init__(jload_options(path), "unused")
        got = infer_nuscenes.eval_view_config(load_options(path))
        for f in dataclasses.fields(got):
            if f.name not in ("img_jitter", "augment", "pcd_aug"):
                assert as_value(getattr(got, f.name)) == as_value(getattr(inf.cfg, f.name)), \
                    f.name
    pmf = tdata.pv_config(load_options(os.path.join(CONFIGS, "pmf_nuscenes.yaml")))
    assert pmf.projection == "cam" and (pmf.h_pad, pmf.w_pad, pmf.n_points) == (0, 0, 65536)


def _write_cfg(root, net, data_root, **extra):
    """A small config of the shipped nuScenes yaml of `net` (base 8, float32,
    the fixture's images, 2048 points)."""
    shipped = yaml.safe_load(open(os.path.join(CONFIGS, {
        "PMFNet": "pmf_nuscenes.yaml", "EPMFNet": "epmf_nuscenes.yaml",
        "SalsaNext": "salsanext_nuscenes.yaml"}[net])))
    cfg = dict(shipped, save_path=str(root / "runs"), data_root=data_root, seed=3,
               base_channels=8, compute_dtype="float32", batch_size=[2, 2], n_epochs=1,
               experiment_id="cli", use_packed=False, post=KNN)
    if net == "PMFNet":
        cfg["sensor"] = dict(shipped["sensor"], **SENSOR, img_mean=MEAN, img_stds=STDS)
    elif net == "EPMFNet":
        cfg["PVconfig"] = dict(shipped["PVconfig"], **SENSOR)
    else:
        cfg["sensor"] = dict(shipped["sensor"], proj_h=16, proj_w=128, n_points=N_POINTS)
    for k, v in extra.items():
        cfg[k] = dict(cfg[k], **v) if isinstance(v, dict) else v
    path = str(root / f"{net}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _bins(d, split="val"):
    d = os.path.join(d, "lidarseg", split)
    return {f: np.fromfile(os.path.join(d, f), dtype=np.uint8) for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("net", ["PMFNet", "EPMFNet"])
def test_nuscenes_inference_matches_jax(request, tmp_path, net):
    """`infer_nuscenes` (per item: the eval view through K1's plain version,
    the forward, the gather or KNN; the six-camera max-confidence merge) on
    the val keyframes against pmf_tpu's NuscenesInference on the same
    weights, without and with KNN: the lidarseg files equal on the covered
    points (either side's class > 0; at least 500 of them a keyframe) but
    for at most 2, and on >= 99.5 % of all points; mIoU within 0.002.
    EPMF runs on `nusc_front` at a 128x256 view: pmf_tpu's EPMF branch
    crops every camera's item by the lidar frame's ±45° yaw (ROADMAP C6),
    which on `nusc`'s points all around leaves a tight box that the centre
    crop holds almost no point of."""
    nusc = request.getfixturevalue("nusc_front" if net == "EPMFNet" else "nusc")
    path = _write_cfg(tmp_path, net, nusc, **({"PVconfig": dict(SENSOR, proj_h=128, proj_w=256)}
                                              if net == "EPMFNet" else {}))
    cls = tmodels.EPMFNet if net == "EPMFNet" else tmodels.PMFNet
    model = tmodels.random_weights(cls(nclasses=17, base_channels=8), seed=21)
    params, stats = convert_pmf_state_dict(_numpy_sd(model))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save_best({"params": params, "batch_stats": stats}, "IOU")
    template = jax.tree_util.tree_map(np.zeros_like, {"params": params, "batch_stats": stats})
    weights = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), weights)
    build = jinfer.build_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinfer, "build_model", lambda opts: _TemplateInit(build(opts), template))
        jax_inf = jinfer.NuscenesInference(jload_options(path),
                                           os.path.join(ckpt.directory, "best_IOU_model"))
    for knn in (False, True):
        jax_preds, preds = str(tmp_path / f"jax{knn}"), str(tmp_path / f"torch{knn}")
        jax_inf.use_knn, jax_inf.save_preds = knn, jax_preds
        jax_inf.point_eval.reset()
        want_out = jax_inf.run()
        out = infer_nuscenes.main([path, "--weights", weights, "--save-preds", preds,
                                   "--device", "cpu"] + ["--knn"] * knn)
        got, want = _bins(preds), _bins(jax_preds)
        assert got.keys() == want.keys() and len(got) == out["frames"] == 2
        for k in got:
            assert got[k].shape == want[k].shape == (4000,)
            assert (got[k] == want[k]).mean() >= 0.995
            covered = (got[k] > 0) | (want[k] > 0)
            assert covered.sum() >= 500 and (got[k] != want[k])[covered].sum() <= 2
        assert abs(out["mIoU"] - want_out["mIoU"]) <= 0.002 and np.isfinite(out["mIoU"])
        assert 0 < out["coverage"] < 1 and len(np.unique(np.concatenate(list(got.values())))) > 2


def test_merge_and_validate_match_jax(nusc, tmp_path):
    """`merge_predictions` and `validate_submission` against pmf_tpu's on
    the same files: every output byte-equal, and the check passing, or
    raising the same error, alike."""
    rng = np.random.default_rng(5)
    ds = tnusc.Nuscenes(nusc, version="v1.0-mini", split="train", has_image=False)
    ds_val = tnusc.Nuscenes(nusc, version="v1.0-mini", split="val", has_image=False)
    tokens = [ds.lidar_token(0)] + [ds_val.lidar_token(i) for i in range(2)]
    for kind in ("main", "sub"):
        d = tmp_path / kind / "lidarseg" / "test"
        d.mkdir(parents=True)
        for t in tokens[:3 if kind == "main" else 2]:
            pred = rng.integers(0, 17, 4000).astype(np.uint8)
            pred[rng.random(4000) < (0.6 if kind == "main" else 0.2)] = 0
            pred.tofile(str(d / f"{t}_lidarseg.bin"))
    n = merge_nuscenes_submission.main(["--main-dir", str(tmp_path / "main"), "--sub-dir",
                                        str(tmp_path / "sub"), "--out-dir", str(tmp_path / "t")])
    assert n == jmerge.merge_predictions(str(tmp_path / "main"), str(tmp_path / "sub"),
                                         str(tmp_path / "j")) == 3
    for rel in ["test/submission.json"] + [f"lidarseg/test/{t}_lidarseg.bin" for t in tokens]:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
    assert merge_nuscenes_submission.validate_submission(str(tmp_path / "t"), nusc, "v1.0-mini")
    assert jmerge.validate_submission(str(tmp_path / "j"), nusc, "v1.0-mini")
    merge_nuscenes_submission.merge_predictions(str(tmp_path / "main"), None, str(tmp_path / "t2"))
    for bad, err in ((0, FileNotFoundError), (1, ValueError)):
        path = tmp_path / "t2" / "lidarseg" / "test" / f"{tokens[bad]}_lidarseg.bin"
        if bad:
            np.zeros(4000, np.uint8).tofile(str(path))
        else:
            path.unlink()
        for mod in (merge_nuscenes_submission, jmerge):
            with pytest.raises(err):
                mod.validate_submission(str(tmp_path / "t2"), nusc, "v1.0-mini")
        if not bad:
            np.full(4000, 3, np.uint8).tofile(str(path))


def test_salsanext_nuscenes_matches_jax(nusc, tmp_path):
    """`infer_salsanext` on nuScenes (one item a keyframe, no images) against
    pmf_tpu's SalsaNextInference on the same weights: the lidarseg files on
    >= 99.5 % of the points, mIoU within 0.002; the test split reads no
    labels and still writes its files."""
    path = _write_cfg(tmp_path, "SalsaNext", nusc)
    model = tmodels.random_weights(tmodels.SalsaNext(nclasses=17, base_channels=8), seed=22)
    params, stats = convert_generic_state_dict(_numpy_sd(model))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save_best({"params": params, "batch_stats": stats}, "IOU")
    weights = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), weights)
    jax_preds, preds = str(tmp_path / "jax"), str(tmp_path / "torch")
    want_out = jinfer_salsanext.SalsaNextInference(
        jload_options(path), os.path.join(ckpt.directory, "best_IOU_model"), use_knn=True,
        save_preds=jax_preds).run()
    out = infer_salsanext.main([path, "--weights", weights, "--knn", "--save-preds", preds,
                                "--device", "cpu"])
    got, want = _bins(preds), _bins(jax_preds)
    assert got.keys() == want.keys() and len(got) == 2
    for k in got:
        assert got[k].shape == (4000,) and (got[k] == want[k]).mean() >= 0.995
    assert abs(out["mIoU"] - want_out["mIoU"]) <= 0.002 and np.isfinite(out["mIoU"])
    test = infer_salsanext.main([path, "--weights", weights, "--save-preds", preds, "--split",
                                 "test", "--device", "cpu"])
    assert len(_bins(preds, "test")) == 1 and test["mIoU"] == 0.0


@pytest.mark.parametrize("debug", [False, True])
def test_trainer_nuscenes_data_matches_jax(nusc, tmp_path, monkeypatch, debug):
    """`Trainer.from_files` on nuScenes against pmf_tpu's trainer on the same
    config (stopped after its data): alpha, the ignored classes, the class
    names, the item counts, and the `--debug` switch to v1.0-mini (the
    config names v1.0-trainval, which this DB links to)."""
    path = _write_cfg(tmp_path, "PMFNet", nusc, nusc_version="v1.0-trainval", is_debug=debug)
    opts = load_options(path)
    seen = []
    real = tnusc.Nuscenes
    monkeypatch.setattr(tdata, "Nuscenes", real)
    import pmf_tpu_torch.train.trainer as ttrainer
    monkeypatch.setattr(ttrainer, "Nuscenes",
                        lambda root, **k: seen.append(k["version"]) or real(root, **k))
    trainer = Trainer.from_files(opts, tmodels.PMFNet(nclasses=17, base_channels=8), "cpu")
    jt = jtrainer.Trainer.__new__(jtrainer.Trainer)
    jt.opts = jload_options(path)
    jt.mesh = type("Mesh", (), {"shape": {"data": 1}})()
    jseen = []
    jreal = jtrainer.Nuscenes
    monkeypatch.setattr(jtrainer, "Nuscenes",
                        lambda root, **k: jseen.append(k["version"]) or jreal(root, **k))
    monkeypatch.setattr(jtrainer, "HostLoader", _stop)
    with pytest.raises(_Stop):
        jt._init_data()
    assert seen == jseen == ["v1.0-mini" if debug else "v1.0-trainval"] * 2
    _equal(np.asarray(trainer.loss_cfg.alpha, np.float32), jt.alpha)
    assert list(trainer.metrics.include) == [c for c in range(17) if c not in jt.ignore_class]
    assert trainer.class_names == jt.mapped_cls_name
    assert trainer.loaders["Train"].n_samples == jt._train_len == 6
    assert trainer.loaders["Validation"].n_samples == jt._val_len == 12
    assert trainer.view_cfg.projection == "cam"


@pytest.mark.parametrize("net", ["PMFNet", "EPMFNet", "SalsaNext"])
def test_train_cli_nuscenes_configs(nusc, tmp_path, net):
    """Each shipped nuScenes config (cut to base 8 and the fixture's
    images) through `tools/train.py --debug --device cpu` (v1.0-mini): a
    train and a validation iteration, finite losses, the snapshots; the
    last snapshot through the net's eval CLI on the val keyframes."""
    path = _write_cfg(tmp_path, net, nusc)
    best = train_cli.main([path, "--device", "cpu", "--debug"])
    assert set(best) == {"Acc", "IOU", "Recall"}
    run_dir = os.path.join(str(tmp_path / "runs"), f"nuScenes-{net}-resnet34-bs2-lr0.001-cli")
    log = open(os.path.join(run_dir, "log", "experiment.log")).read()
    assert log.count(">>> Train") == 1 and log.count(">>> Validation") == 1
    assert "Loss nan" not in log
    snapshot = os.path.join(run_dir, "checkpoint", "best_last_model.pth")
    preds = str(tmp_path / "preds")
    if net == "SalsaNext":
        out = infer_salsanext.main([path, "--weights", snapshot, "--save-preds", preds,
                                    "--device", "cpu"])
    else:
        out = infer_nuscenes.main([path, "--weights", snapshot, "--knn", "--save-preds", preds,
                                   "--max-frames", "1", "--device", "cpu"])
        assert out["frames"] == 1
    assert np.isfinite(out["mIoU"]) and len(_bins(preds)) >= 1


@pytest.mark.parametrize("net", ["PMFNet", "EPMFNet", "SalsaNext"])
def test_conv_init_is_pmf_tpus_lecun_normal(net):
    """C1: a fresh `build_model` of each net draws every conv kernel from
    flax's `lecun_normal` (per layer of >= 4096 weights: std within 5 % of
    1/sqrt(fan_in), no value beyond the truncation at 2 of its std, as
    flax's own draw of such a kernel), and every conv bias is 0; the draw
    repeats under `torch.manual_seed`."""
    from flax import linen as fnn

    opts = load_options(os.path.join(CONFIGS, {
        "PMFNet": "pmf_nuscenes.yaml", "EPMFNet": "epmf_nuscenes.yaml",
        "SalsaNext": "salsanext_nuscenes.yaml"}[net]))
    opts.base_channels = 8
    torch.manual_seed(1)
    model = tmodels.build_model(opts)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) > 20
    checked = 0
    for m in convs:
        w = m.weight.detach().double()
        fan_in = w[0].numel()
        bound = 2.0 * (1.0 / fan_in) ** 0.5 / LECUN_TRUNC
        assert w.abs().max() <= bound * (1 + 1e-6)
        if m.bias is not None:
            assert not m.bias.any()
        if w.numel() >= 4096:
            assert abs(w.std().item() * fan_in ** 0.5 - 1.0) <= 0.05, m
            checked += 1
    assert checked > 10
    torch.manual_seed(1)
    again = tmodels.build_model(opts)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))
    # flax's own draw of one such kernel: the same scale and truncation
    kernel = fnn.initializers.lecun_normal()(jax.random.PRNGKey(0), (3, 3, 64, 64))
    fan_in = 3 * 3 * 64
    assert abs(float(jnp.std(kernel)) * fan_in ** 0.5 - 1.0) <= 0.05
    assert float(jnp.abs(kernel).max()) <= 2.0 * (1.0 / fan_in) ** 0.5 / LECUN_TRUNC * (1 + 1e-6)
