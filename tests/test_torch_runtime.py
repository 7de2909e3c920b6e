"""The port's training runtime against pmf_tpu's: HostLoader, the native
scan reader, check_run_dir, the Recorder and logger, the pretrained ResNet
load, and the train CLI's run directory and scalar tags."""
import json
import logging
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pmf_tpu.config import check_run_dir as jcheck_run_dir
from pmf_tpu.config import load_options as jload_options
from pmf_tpu.data import SemanticKitti as JSemanticKitti
from pmf_tpu.data import loader as jloader
from pmf_tpu.data import native as jnative
from pmf_tpu.metrics import IOUEval as JIOUEval
from pmf_tpu.models.torch_convert import convert_pmf_state_dict, load_pretrained_resnet_into
from pmf_tpu.train import steps as jsteps
from pmf_tpu.train.recorder import Recorder as JRecorder
from pmf_tpu.train.trainer import Trainer as JTrainer
from pmf_tpu.utils.meters import RemainTime as JRemainTime
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch.config import check_run_dir
from pmf_tpu_torch.data import SemanticKitti, loader as tloader, native
from pmf_tpu_torch.data.perspective_pipeline import PVConfig, pad_image
from pmf_tpu_torch.data.synthetic import resnet_state_dict
from pmf_tpu_torch.tools import train as train_cli
from pmf_tpu_torch.train import Recorder
from pmf_tpu_torch.utils import logger as tlogger
from tests.test_data_pipeline import make_synthetic_kitti

CFG = dict(canvas_h=64, canvas_w=160, proj_h=64, proj_w=160, proj_ht=48, proj_wt=96,
           h_pad=2, w_pad=2, n_points=1024)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several test processes side by
    side on the cores (tests/test_torch_train.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ------------------------------------------------------------------ HostLoader


def _reader(i: int) -> dict:
    rng = np.random.default_rng(i)
    return {"x": rng.random((3, 2)).astype(np.float32), "y": rng.integers(0, 9, 4),
            "index": np.int32(i)}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("n, bs, shuffle, drop_last, rank, world, workers, epoch", [
    (7, 3, False, False, 0, 1, 1, 0),      # the padded last batch
    (7, 3, False, True, 0, 1, 4, 0),       # drop_last
    (10, 3, True, True, 0, 1, 4, 3),       # shuffle, set_epoch
    (11, 2, True, True, 1, 2, 4, 1),       # rank 1 of 2
    (11, 3, False, False, 0, 2, 1, 0),     # rank 0 of 2, padded
    (11, 3, False, False, 1, 2, 4, 0),     # rank 1 of 2, padded
])
def test_host_loader_batches_equal_pmf_tpus(n, bs, shuffle, drop_last, rank, world, workers,
                                             epoch):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5, num_workers=workers, prefetch=2,
              process_index=rank, process_count=world)
    got, want = tloader.HostLoader(_reader, n, bs, **kw), jloader.HostLoader(_reader, n, bs, **kw)
    got.set_epoch(epoch)
    want.set_epoch(epoch)
    assert len(got) == len(want) > 0
    _assert_batches_equal(list(got), list(want))


class _Frames:
    """SensatUrban's readDataByIndex on frames of three sizes."""

    def readDataByIndex(self, i):
        rng = np.random.default_rng(i)
        h, w = (40, 36, 20)[i % 3], (30, 44, 20)[i % 3]
        return {"feature_map": rng.random((8, h, w)), "label_map": rng.integers(-1, 13, (h, w))}


def test_host_loader_sensat_reader_at_one_worker_equals_pmf_tpus():
    """The SensatUrban train reader draws each window from one RandomState
    shared by the reader's calls (pmf_tpu's: numpy's global one), so the
    crops follow the order in which the reader runs: with one worker,
    pmf_tpu's loader and the port's give the same batches (ROADMAP C9)."""
    cfg = types.SimpleNamespace(img_h=8, img_w=12)
    weights = [2, 0, 1, 1, 2, 0]
    port = tloader.sensat_sample_reader(_Frames(), cfg, weights,
                                        rng=np.random.RandomState(4))
    np.random.seed(4)
    jax_reader = jloader.sensat_sample_reader(_Frames(), cfg, weights)
    kw = dict(shuffle=True, drop_last=True, seed=2, num_workers=1)
    got = list(tloader.HostLoader(port, 6, 2, **kw))
    want = list(jloader.HostLoader(jax_reader, 6, 2, **kw))
    _assert_batches_equal(got, want)

# -------------------------------------------------------------- native reader


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    return make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti_rt")), n_scans=2,
                                n_points=800)


def test_native_reader_equals_pmf_tpus_and_numpy(kitti):
    assert native.available() and native.image_available() and jnative.available()
    ds, jds = SemanticKitti(kitti, [0]), JSemanticKitti(kitti, [0])
    cfg = PVConfig(canvas_h=64, canvas_w=160, n_points=1024)
    lut = ds.class_map_lut
    for i in range(len(ds)):
        args = (ds.pointcloud_files[i], ds.label_files[i], lut, cfg.n_points)
        for a, b in zip(native.read_scan(*args), jnative.read_scan(*args)):
            np.testing.assert_array_equal(a, b)
        img = native.decode_image(ds.image_files[i], cfg.canvas_h, cfg.canvas_w)
        for a, b, c in zip(img, jnative.decode_image(ds.image_files[i], cfg.canvas_h,
                                                     cfg.canvas_w),
                           pad_image(ds.loadImage(i), cfg.canvas_h, cfg.canvas_w)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        full = (ds.pointcloud_files[i], ds.label_files[i], ds.image_files[i], lut,
                cfg.n_points, cfg.canvas_h, cfg.canvas_w)
        for a, b in zip(native.read_scan_full(*full), jnative.read_scan_full(*full)):
            np.testing.assert_array_equal(a, b)
    batch = (ds.pointcloud_files, ds.label_files, lut, cfg.n_points)
    for a, b in zip(native.read_scan_batch(*batch), jnative.read_scan_batch(*batch)):
        np.testing.assert_array_equal(a, b)

    fast, slow = tloader.kitti_sample_reader(ds, cfg), tloader.kitti_sample_reader(ds, cfg, False)
    ref = jloader.kitti_sample_reader(jds, cfg)
    assert fast.native and not slow.native
    for i in range(len(ds)):
        got, numpy_path, want = fast(i), slow(i), ref(i)
        assert got.keys() == numpy_path.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(numpy_path[k], want[k], err_msg=k)


def test_native_reader_falls_back_to_pil_then_stops_trying(kitti, tmp_path, monkeypatch):
    """A palette PNG, which the native decoder refuses, is read by PIL with
    the same result; after 3 such failures in a row the reader stops trying
    the native image decode."""
    from PIL import Image

    ds = SemanticKitti(kitti, [0])
    paths = []
    for i, f in enumerate(ds.image_files):
        paths.append(str(tmp_path / f"p{i}.png"))
        Image.open(f).convert("P").save(paths[-1])
    ds.image_files = paths
    calls = []
    full = native.read_scan_full
    monkeypatch.setattr(native, "read_scan_full", lambda *a: calls.append(1) or full(*a))
    cfg = PVConfig(canvas_h=64, canvas_w=160, n_points=1024)
    read, slow = tloader.kitti_sample_reader(ds, cfg), tloader.kitti_sample_reader(ds, cfg, False)
    for k in range(5):
        got, want = read(k % 2), slow(k % 2)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(calls) == 3

# ------------------------------------------------------------- check_run_dir


def _outcome(check, tmp, case, monkeypatch, capsys):
    d = tmp / "run"
    if case != "missing":
        d.mkdir()
        (d / "log.txt").write_text("old")
    policy = {"missing": "abort", "ask_d": "ask", "ask_q": "ask", "auto": "auto"}.get(case, case)
    monkeypatch.setattr("builtins.input", lambda *_: "d" if case == "ask_d" else "q")
    monkeypatch.setattr("sys.stdin.isatty", lambda: False, raising=False)
    try:
        check(str(d), policy)
        raised = None
    except OSError as e:
        raised = type(e)
    return raised, d.exists(), (d / "log.txt").exists(), "reusing" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["missing", "reuse", "delete", "abort", "ask_d", "ask_q",
                                  "auto"])
def test_check_run_dir_matches_pmf_tpu(case, tmp_path, monkeypatch, capsys):
    """The cases of tests/test_options_guard.py, each against pmf_tpu's
    guard: the same exception, directory and warning."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _outcome(check_run_dir, tmp_path / "port", case, monkeypatch, capsys)
    want = _outcome(jcheck_run_dir, tmp_path / "jax", case, monkeypatch, capsys)
    assert got == want
    assert got[0] == (OSError if case in ("abort", "ask_q") else None)

# --------------------------------------------------------- Recorder, logger


def _record(cls, path):
    rec = cls(str(path), settings_dict={"seed": 1, "batch_size": (2, 4), "lr": 0.01},
              snapshot_code=True, use_tensorboard=False)
    rec.add_scalar("Train_Loss", 1.25, 0)
    rec.add_scalar("Validation_meanIOU", np.float32(0.5), 3)
    rec.add_image("Train_RGB", np.random.default_rng(0).random((4, 6, 3)), 0)
    rec.close()
    with open(path / "log" / "scalars.jsonl") as f:
        lines = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]
    with open(path / "settings.json") as f:
        return json.load(f), lines, sorted(os.listdir(path / "log" / "images"))


def test_recorder_writes_what_pmf_tpus_writes(tmp_path):
    got, want = _record(Recorder, tmp_path / "port"), _record(JRecorder, tmp_path / "jax")
    assert got == want
    code = tmp_path / "port" / "code" / "pmf_tpu_torch"
    assert (code / "train" / "recorder.py").is_file() and (code / "tools" / "train.py").is_file()
    assert not (tmp_path / "port" / "code" / "pmf_tpu").exists()
    for sub in ("log", "checkpoint", "code", "settings.json"):
        assert (tmp_path / "jax" / sub).exists() and (tmp_path / "port" / sub).exists()


def test_logger_and_recorder_are_silent_off_rank_0(tmp_path, monkeypatch, capsys):
    assert tlogger.is_main_process()
    monkeypatch.setattr(tlogger.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tlogger.dist, "get_rank", lambda: 1)
    assert not tlogger.is_main_process()
    rec = Recorder(str(tmp_path / "run"), settings_dict={"a": 1}, snapshot_code=True)
    rec.logger.info("not shown")
    rec.add_scalar("x", 1.0, 0)
    rec.add_image("y", np.zeros((2, 2)), 0)
    rec.close()
    assert not (tmp_path / "run").exists()
    assert [type(h) for h in tlogger.make_logger("pmf_tpu_torch.rt").handlers] == \
        [logging.NullHandler]
    assert "not shown" not in capsys.readouterr().out

# ----------------------------------------------------------- pretrained load


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_pretrained_resnet_load_equals_pmf_tpus(suffix, tmp_path, caplog):
    """A torchvision-named ResNet34 state_dict from a seed (with fc.* and
    one tensor of the wrong shape) into PMFNet's camera encoder: the
    model's state equals pmf_tpu's load_pretrained_resnet_into result
    carried through the port's converter, and the wrong tensor is skipped
    and logged."""
    sd = resnet_state_dict(seed=3)
    sd["layer2.1.conv2.weight"] = torch.zeros(128, 128, 1, 1)
    path = str(tmp_path / f"resnet34{suffix}")
    if suffix == ".pth":
        torch.save(sd, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    torch.manual_seed(0)
    model = tmodels.PMFNet(nclasses=20, base_channels=8)
    template = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    log = logging.getLogger("test_pretrained")
    with caplog.at_level(logging.INFO, logger="test_pretrained"):
        tmodels.load_pretrained_resnet(model, path, "resnet34", log=log)
    params, stats = convert_pmf_state_dict(template)
    jvars = load_pretrained_resnet_into({"params": params, "batch_stats": stats}, path,
                                        "resnet34")
    want = tmodels.state_dict_from_flax(model, jvars["params"], jvars["batch_stats"])
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    enc = model.camera_stream_encoder.state_dict()
    assert torch.equal(enc["layer1.0.conv1.weight"], sd["layer1.0.conv1.weight"])
    assert torch.equal(enc["layer2.1.conv2.weight"],
                       torch.from_numpy(template["camera_stream_encoder.layer2.1.conv2.weight"]))
    assert "partial_load: skipping layer2.1.conv2.weight" in caplog.text

# ------------------------------------------------------------------ train CLI


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli_rt")
    data = make_synthetic_kitti(str(root / "sequences"), n_scans=2, n_points=800)
    for seq in range(1, 11):
        os.symlink(os.path.join(data, "00"), os.path.join(data, f"{seq:02d}"))
    weights = str(root / "resnet34.pth")
    torch.save(resnet_state_dict(seed=4), weights)
    cfg = {"save_path": str(root / "runs"), "seed": 3, "experiment_id": "rt", "n_epochs": 1,
           "batch_size": [2, 2], "lr": 0.01, "dataset": "SemanticKitti", "nclasses": 20,
           "data_root": data, "net_type": "PMFNet", "base_channels": 8,
           "img_backbone": "resnet34", "pretrained_weights": weights, "n_threads": 2,
           "sensor": dict(CFG)}
    path = str(root / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    run_dir = os.path.join(cfg["save_path"], "SemanticKitti-PMFNet-resnet34-bs2-lr0.01-rt")
    os.makedirs(os.path.join(run_dir, "stale"))
    return path, run_dir, root


class _Loader(list):
    def set_epoch(self, epoch):
        pass


def _pmf_tpu_tags(cfg_path: str, out_dir: str):
    """The scalar tags and image panels pmf_tpu's Trainer.run writes for one
    train and one validation epoch of the config's PMFNet: its own run loop
    and recording code, driven with stand-in data and steps (the aux keys of
    its pmf_losses) instead of compiled ones."""
    opts = jload_options(cfg_path)
    C, (h, w) = opts.nclasses, (CFG["proj_ht"], CFG["proj_wt"])
    shapes = [jax.ShapeDtypeStruct((1, 4, 4, C), jnp.float32)] * 2 + \
        [jax.ShapeDtypeStruct((1, 4, 4), jnp.int32)]
    keys = jax.eval_shape(lambda a, b, c: jsteps.pmf_losses(
        a, b, c, jsteps.LossConfig(alpha=(1.0,) * C))[1], *shapes).keys()
    aux = {**{k: np.float32(0.5) for k in keys}, "conf": np.eye(C), "conf_cam": np.eye(C)}
    batch = {"batch_valid": np.ones(2, bool)}
    probs = np.full((1, h, w, C), 1.0 / C, np.float32)
    stub = types.SimpleNamespace(
        opts=opts, train_loader=_Loader([batch]), val_loader=_Loader([batch]),
        metrics=JIOUEval(C, ignore=[0]), metrics_img=JIOUEval(C, ignore=[0]),
        remain_time=JRemainTime(opts.n_epochs), _key=jax.random.PRNGKey(0),
        _device_batch=lambda b, train, key: (np.zeros((2, h, w, 8), np.float32),
                                             np.zeros((2, h, w), np.int32), None),
        point_lovasz=True, train_step=lambda state, *a: (state, aux),
        eval_step=lambda state, *a: (aux, None), lr_schedule=lambda step: 0.01,
        state=types.SimpleNamespace(step=0), is_fusion=True,
        mapped_cls_name=JSemanticKitti(opts.data_root, [0]).mapped_cls_name,
        recorder=JRecorder(out_dir, use_tensorboard=False),
        _panel_forward=lambda state, feature: (probs, probs))
    stub._log_image_panels = lambda mode, epoch: JTrainer._log_image_panels(stub, mode, epoch)
    for mode in ("Train", "Validation"):
        JTrainer.run(stub, 0, mode)
    stub.recorder.close()
    with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    return tags, set(os.listdir(os.path.join(out_dir, "log", "images")))


def test_train_cli_run_directory_and_tags_match_pmf_tpu(cli_setup, monkeypatch):
    """`tools/train.py --device cpu --debug --overwrite-policy delete` with
    `pretrained_weights`: the old run directory is replaced by pmf_tpu's
    layout, the scalar tags and image panels of the epoch are the ones
    pmf_tpu's Trainer writes, and `abort` on the existing directory
    raises. TensorBoard's import is blocked (here it imports TensorFlow,
    15-18 s): the Recorder then writes no events, as where it is absent."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path, run_dir, root = cli_setup
    best = train_cli.main([path, "--device", "cpu", "--debug", "--overwrite-policy", "delete"])
    assert set(best) == {"Acc", "IOU", "Recall"}
    assert not os.path.exists(os.path.join(run_dir, "stale"))
    for sub in ("settings.json", "log/experiment.log", "log/scalars.jsonl", "log/images",
                "code/pmf_tpu_torch/train/trainer.py", "checkpoint/checkpoint.pth",
                "checkpoint/best_IOU_model.pth"):
        assert os.path.exists(os.path.join(run_dir, sub)), sub
    with open(os.path.join(run_dir, "settings.json")) as f:
        assert json.load(f)["pretrained_weights"].endswith("resnet34.pth")
    with open(os.path.join(run_dir, "log", "experiment.log")) as f:
        assert "partial_load: matched 180/180 tensors" in f.read()
    with open(os.path.join(run_dir, "log", "scalars.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert all(np.isfinite(r["value"]) for r in records)
    want_tags, want_images = _pmf_tpu_tags(path, str(root / "jax_run"))
    assert {r["tag"] for r in records} == want_tags
    assert set(os.listdir(os.path.join(run_dir, "log", "images"))) == want_images
    with pytest.raises(OSError):
        train_cli.main([path, "--device", "cpu", "--debug", "--overwrite-policy", "abort"])
