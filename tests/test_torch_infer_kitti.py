"""The slice end to end: the port's eval CLI against pmf_tpu's Inference on
a synthetic SemanticKITTI sequence, with the same weights and KNN lifting
on. Per-point predictions must agree on >= 99.5% of the points and mIoU
within 0.002."""
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from pmf_tpu.models.torch_convert import convert_pmf_state_dict
from pmf_tpu_torch.config import load_options
from pmf_tpu_torch.models import PMFNet, random_weights
from pmf_tpu_torch.tools import infer_kitti
from pmf_tpu_torch.utils import resolve_device
from pmf_tpu_torch.utils import tables as ttables
from pmf_tpu.utils import tables as jtables
from tests.test_data_pipeline import make_synthetic_kitti
from tests.test_torch_models import save_flat_flax_npz
from tests.torch_threads import one_torch_thread  # noqa: F401

N_SCANS = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_cli")
    data = make_synthetic_kitti(str(root / "sequences"), n_scans=N_SCANS, n_points=800)
    os.symlink(os.path.join(data, "00"), os.path.join(data, "08"))
    cfg = {
        "dataset": "SemanticKitti", "nclasses": 20, "data_root": data,
        "net_type": "PMFNet", "base_channels": 8, "img_backbone": "resnet34",
        "compute_dtype": "float32", "batch_size": [1, 1],
        "sensor": {"canvas_h": 64, "canvas_w": 160, "proj_h": 64, "proj_w": 160,
                   "h_pad": 2, "w_pad": 2, "n_points": 1024,
                   "img_mean": [12.12, 10.88, 0.23, -1.04, 0.21],
                   "img_stds": [12.32, 11.47, 6.91, 0.86, 0.16]},
        "post": {"KNN": {"params": {"knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}},
    }
    cfg_path = str(root / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    model = random_weights(PMFNet(nclasses=20, base_channels=8), seed=11)
    weights = str(root / "weights.pth")
    torch.save(model.state_dict(), weights)
    return {"root": root, "cfg": cfg_path, "weights": weights, "model": model}


class _TemplateInit:
    """pmf_tpu's eval model whose `init` returns `variables`, a tree of the
    model's own structure, as the template that the checkpoint restore
    fills: the restore overwrites every leaf, and a real init of PMFNet costs
    half a minute of compiling on the CPU."""

    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def init(self, *args, **kwargs):
        return self.variables

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


@pytest.fixture(scope="module")
def jax_run(setup):
    from pmf_tpu.config import load_options as jax_load_options
    from pmf_tpu.tools import infer_kitti as jax_infer_kitti
    from pmf_tpu.train.checkpoint import CheckpointManager

    params, stats = convert_pmf_state_dict(
        {k: v.numpy() for k, v in setup["model"].state_dict().items()})
    ckpt = CheckpointManager(str(setup["root"] / "ckpt"))
    ckpt.save_best({"params": params, "batch_stats": stats}, "IOU")
    # the template holds other values than the checkpoint, so the restore
    # is seen to overwrite them
    template = jax.tree_util.tree_map(np.zeros_like, {"params": params, "batch_stats": stats})
    preds = str(setup["root"] / "preds_jax")
    build = jax_infer_kitti.build_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_infer_kitti, "build_model",
                   lambda opts: _TemplateInit(build(opts), template))
        inf = jax_infer_kitti.Inference(jax_load_options(setup["cfg"]),
                                        os.path.join(ckpt.directory, "best_IOU_model"),
                                        use_knn=True, save_preds=preds)
    return inf.run(), preds


def _labels(preds_dir):
    d = os.path.join(preds_dir, "sequences", "08", "predictions")
    return [np.fromfile(os.path.join(d, f), dtype=np.int32) for f in sorted(os.listdir(d))]


def test_cli_matches_jax_inference(setup, jax_run):
    jax_out, jax_preds = jax_run
    preds = str(setup["root"] / "preds_torch")
    out = infer_kitti.main([setup["cfg"], "--weights", setup["weights"], "--knn",
                            "--save-preds", preds, "--device", "cpu"])
    got, want = _labels(preds), _labels(jax_preds)
    assert len(got) == len(want) == N_SCANS
    for g, w in zip(got, want):
        assert g.shape == w.shape == (800,)
        assert (g == w).mean() >= 0.995
    for tag in ("pixel", "point"):
        assert abs(out[tag]["mIoU"] - jax_out[tag]["mIoU"]) <= 0.002
        assert np.isfinite(out[tag]["mIoU"])


def test_cli_without_knn_and_npz_weights(setup, tmp_path):
    """The gather lift, and weights given as the flat flax tree: same
    predictions as the .pth weights."""
    npz = save_flat_flax_npz(str(tmp_path / "w.npz"), setup["model"])
    runs = []
    for i, w in enumerate((setup["weights"], npz)):
        d = str(tmp_path / f"preds_{i}")
        runs.append(infer_kitti.main([setup["cfg"], "--weights", w, "--max-scans", "1",
                                      "--save-preds", d, "--device", "cpu"]))
        runs[-1]["labels"] = _labels(d)
    assert len(runs[0]["labels"]) == 1
    np.testing.assert_array_equal(runs[0]["labels"][0], runs[1]["labels"][0])
    assert runs[0]["point"] == runs[1]["point"]


def test_options_and_device():
    opts = load_options(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "experiments", "pmf_kitti.yaml"))
    assert (opts.nclasses, opts.base_channels, opts.img_backbone) == (20, 32, "resnet34")
    assert opts.compute_dtype == "bfloat16"
    cfg = infer_kitti.pv_config(opts)
    assert (cfg.proj_h, cfg.proj_w, cfg.n_points) == (384, 1232, 32768)
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()


def test_report_tables_match_jax():
    rng = np.random.default_rng(0)
    conf = rng.integers(0, 50, (4, 4)).astype(np.float64)
    names = {0: "unlabeled", 1: "car", 2: "bicycle", 3: "road"}
    iou, acc, rec = rng.random(4), rng.random(4), rng.random(4)
    assert ttables.per_class_report(names, iou, acc, rec, [1, 2, 3]) == \
        jtables.per_class_report(names, iou, acc, rec, [1, 2, 3])
    assert ttables.latex_row(iou, [1, 2, 3]) == jtables.latex_row(iou, [1, 2, 3])
    for norm in (None, "acc", "recall"):
        assert ttables.matrix_report(conf, names, norm) == jtables.matrix_report(conf, names, norm)
