"""The port's eval data path against pmf_tpu on the CPU: projection, the
scan reader, the per-scan and batched views, normalization, KNN lifting and
the IoU metrics. Integer outputs and the canvas copies must match bit for
bit."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pmf_tpu import data as jdata
from pmf_tpu.metrics import iou as jiou
from pmf_tpu.ops import knn as jknn
from pmf_tpu.ops import projection as jproj
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch.data.synthetic import make_inputs
from pmf_tpu_torch.metrics import iou as tiou
from pmf_tpu_torch.ops import knn as tknn
from pmf_tpu_torch.ops import projection as tproj
from tests.test_data_pipeline import make_synthetic_kitti

CFG = dict(canvas_h=64, canvas_w=160, proj_h=64, proj_w=160, h_pad=2, w_pad=2,
           n_points=1024)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti_torch")))


@pytest.fixture(scope="module")
def samples(kitti_root):
    ds = jdata.SemanticKitti(kitti_root, [0])
    read = jdata.kitti_sample_reader(ds, jdata.PVConfig(**CFG), use_native=False)
    return [read(i) for i in range(len(ds))]


def _t(s, k):
    return torch.as_tensor(np.asarray(s[k]))


def test_reader_and_calib_match_jax(kitti_root, samples):
    ds = tdata.SemanticKitti(kitti_root, [0])
    read = tdata.kitti_sample_reader(ds, tdata.PVConfig(**CFG))
    assert len(ds) == len(samples)
    for i, want in enumerate(samples):
        got = read(i)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    calib = os.path.join(kitti_root, "00", "calib.txt")
    np.testing.assert_array_equal(tproj.read_kitti_calib(calib),
                                  jproj.read_kitti_calib(calib))
    np.testing.assert_array_equal(ds.class_map_lut_inv,
                                  jdata.SemanticKitti(kitti_root, [0]).class_map_lut_inv)


@pytest.mark.parametrize("mode", ["kitti", "cam"])
def test_projection_matches_jax(samples, mode):
    s = samples[0]
    pts, P, valid = s["points"][:, :3], s["proj_matrix"], s["valid"]
    if mode == "kitti":
        got = tproj.perspective_project(torch.from_numpy(pts), torch.from_numpy(P),
                                        int(s["img_h"]), int(s["img_w"]), torch.from_numpy(valid))
        want = jproj.perspective_project(jnp.asarray(pts), jnp.asarray(P),
                                         s["img_h"], s["img_w"], jnp.asarray(valid))
    else:
        got = tproj.perspective_project_cam(torch.from_numpy(pts), torch.from_numpy(P),
                                            int(s["img_h"]), int(s["img_w"]),
                                            valid=torch.from_numpy(valid))
        want = jproj.perspective_project_cam(jnp.asarray(pts), jnp.asarray(P),
                                             s["img_h"], s["img_w"], valid=jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].sum() > 50


def test_eval_sample_matches_jax(samples):
    cfg_t, cfg_j = tdata.PVConfig(**CFG), jdata.PVConfig(**CFG)
    for s in samples:
        got = tdata.build_eval_sample_with_uproj(
            *(_t(s, k) for k in ("points", "labels", "valid", "proj_matrix", "image")),
            int(s["img_h"]), int(s["img_w"]), cfg_t)
        want = jdata.build_eval_sample_with_uproj(
            *(jnp.asarray(s[k]) for k in ("points", "labels", "valid", "proj_matrix", "image")),
            s["img_h"], s["img_w"], cfg_j)
        f, wf = got[0].numpy(), np.asarray(want[0])
        np.testing.assert_allclose(f, wf, atol=1e-6)
        np.testing.assert_array_equal(f[..., 5:], wf[..., 5:])      # RGB copies
        for name, g, w in zip(("mask", "label", "rows", "cols", "keep", "depth"),
                              got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert got[1].sum() > 50


def test_view_pixel_rounding_saturates_as_xla():
    """Points near the camera plane project to coordinates past the int32
    range; the view's round-and-convert gives XLA's ends (and 0 for NaN)
    where a plain cast would give INT32_MIN for both signs."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 7.49, 1e6 + 0.5, 2.0 ** 31, -2.0 ** 31,
                  3e9, -3e9, 1e20, -1e20, np.inf, -np.inf, np.nan, 2147483520.0],
                 np.float32)
    got = tdata.perspective_pipeline._round_to_int32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v: jnp.round(v).astype(jnp.int32))(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def _batch_arrays(samples):
    keys = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
    return [np.stack([np.asarray(s[k]) for s in samples]) for k in keys]


@pytest.mark.parametrize("img_h", [None, 80])
def test_build_batch_matches_jax_scatter(samples, img_h):
    """The port's batched fill (K2's plain version here) against the JAX
    scatter fill, which equals its Pallas fill. img_h = 80 claims an image
    taller than the 64-row canvas, so the crop start is clamped into the
    canvas as lax.dynamic_slice clamps it."""
    arrays = _batch_arrays(samples)
    if img_h is not None:
        arrays[5] = np.full_like(arrays[5], img_h)
    got = tdata.build_batch(*map(torch.from_numpy, arrays), tdata.PVConfig(**CFG))
    want = jdata.build_batch(jax.random.PRNGKey(0), *map(jnp.asarray, arrays),
                             jdata.PVConfig(**CFG, fill="scatter"), False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_array_equal(got[0][..., 5:].numpy(), np.asarray(want[0])[..., 5:])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1].sum() > 100


def test_normalize_feature_matches_jax():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(2, 6, 7, 8)).astype(np.float32) * 20
    m = rng.random((2, 6, 7)) > 0.5
    cfg = tdata.PVConfig()
    got = tdata.normalize_feature(torch.from_numpy(f), torch.from_numpy(m), cfg)
    want = jdata.normalize_feature(jnp.asarray(f), jnp.asarray(m), jdata.PVConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_synthetic_inputs_mirror_bench_with_a_working_camera():
    """Everything as bench.py draws it except the projection, whose bench
    form lands no point in the image; the port's lands most of them."""
    got = make_inputs(np.random.default_rng(3), 2, 4096, 384, 1232)
    want = bench.make_inputs(np.random.default_rng(3), 2, 4096, 384, 1232)
    for i, (g, w) in enumerate(zip(got, want)):
        if i != 3:
            np.testing.assert_array_equal(g, w)
    pts, P = torch.from_numpy(got[0]), torch.from_numpy(got[3])
    h, w = torch.from_numpy(got[5]), torch.from_numpy(got[6])
    assert tproj.perspective_project(pts[..., :3], P, h, w)[2].float().mean() > 0.8
    bench_keep = tproj.perspective_project(pts[..., :3], torch.from_numpy(want[3]), h, w)[2]
    assert not bench_keep.any()


def test_knn_postprocess_matches_jax_with_ties():
    rng = np.random.default_rng(7)
    H, W, P, C = 12, 20, 300, 20
    proj_range = rng.uniform(1, 30, (H, W)).astype(np.float32)
    proj_range[rng.random((H, W)) < 0.3] = -1.0
    argmax = rng.integers(0, C, (H, W)).astype(np.int32)
    py = rng.integers(0, H, P).astype(np.int32)
    px = rng.integers(0, W, P).astype(np.int32)
    unproj = proj_range[py, px].copy()
    unproj[unproj < 0] = rng.uniform(1, 30, (unproj < 0).sum())
    # a tie at the k-th place: the whole window holds the point's own range,
    # so every weighted distance is 0 and the order alone picks the 5
    proj_range[3:8, 3:8] = 10.0
    py[:10], px[:10], unproj[:10] = 5, 5, 10.0
    valid = rng.random(P) > 0.1
    valid[:10] = True
    kw = dict(knn=5, search=5, sigma=1.0, cutoff=1.0, nclasses=C)
    got = tknn.knn_postprocess(torch.from_numpy(proj_range), torch.from_numpy(unproj),
                               torch.from_numpy(argmax), torch.from_numpy(px),
                               torch.from_numpy(py), torch.from_numpy(valid), **kw)
    want = jknn.knn_postprocess(jnp.asarray(proj_range), jnp.asarray(unproj),
                                jnp.asarray(argmax), jnp.asarray(px), jnp.asarray(py),
                                jnp.asarray(valid), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the tie decides: the first five window positions (row 3, cols 3-7) vote
    assert got[0] == np.bincount(argmax[3, 3:8], minlength=C)[1:].argmax() + 1


def test_confusion_and_iou_match_jax():
    rng = np.random.default_rng(8)
    pred = rng.integers(-1, 21, 5000)
    gt = rng.integers(0, 20, 5000)
    valid = rng.random(5000) > 0.2
    got = tiou.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt), 20,
                                torch.from_numpy(valid))
    want = jiou.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), 20, jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t_ev, j_ev = tiou.IOUEval(20, ignore=[0]), jiou.IOUEval(20, ignore=[0])
    for _ in range(2):
        t_ev.addBatch(pred, gt, valid)
        j_ev.addBatch(pred, gt, valid)
    np.testing.assert_array_equal(t_ev.conf, j_ev.conf)
    for name in ("getIoU", "getAcc", "getRecall"):
        (tm, tv), (jm, jv) = getattr(t_ev, name)(), getattr(j_ev, name)()
        assert tm == jm
        np.testing.assert_array_equal(tv, jv)
    assert t_ev.getFwIoU() == j_ev.getFwIoU()
    with pytest.raises(ValueError):
        tiou.confusion_matrix(torch.zeros(2**24 + 1, dtype=torch.int8),
                              torch.zeros(2**24 + 1, dtype=torch.int8), 20)
