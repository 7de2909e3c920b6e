"""The spatial split (the image rows of each sample over a model axis) on
the CPU over gloo: one spawn of 4 processes as data 2 × model 2
(`parallel/dryrun.py: spatial_job`), with timeouts on the group and on the
join, held against the port's one-process computations and pmf_tpu's
H-sharded forward on the 8-device CPU mesh of tests/conftest.py."""
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec as P

from pmf_tpu import models as jmodels
from pmf_tpu.models import layers as jlayers
from pmf_tpu.models.torch_convert import convert_generic_state_dict, convert_pmf_state_dict
from pmf_tpu.parallel import make_mesh as jmake_mesh
from pmf_tpu_torch import parallel
from pmf_tpu_torch.parallel import dryrun, spatial
from tests.test_data_pipeline import make_synthetic_kitti
from tests.test_torch_train import CFG

NETS = list(dryrun.SPLIT_NETS)


def _unsplit(net: str, dtype) -> list:
    model = dryrun.split_model(net, dtype)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a).to(dtype) for a in dryrun.split_inputs(net)))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _jax_sharded(net: str) -> list:
    """pmf_tpu's eval forward of the same float32 weights with the batch
    over `data` (4) and the rows over `model` (2), with its eval BN unfolded
    (`layers.FOLD_EVAL_BN`): so tests/test_parallel.py finds it exact, where
    the folded program moves the probabilities by up to 2e-3."""
    model = dryrun.split_model(net)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    convert = convert_generic_state_dict if net == "SalsaNext" else convert_pmf_state_dict
    params, stats = convert(sd)
    flax_model = getattr(jmodels, net)(nclasses=20, base_channels=8)
    mesh = jmake_mesh(data=4, model=2)
    inputs = [jax.device_put(a, NamedSharding(mesh, P("data", "model")))
              for a in dryrun.split_inputs(net)]
    kw = {} if net == "SalsaNext" else {"train": False}
    fold, jlayers.FOLD_EVAL_BN = jlayers.FOLD_EVAL_BN, False
    try:
        out = jax.jit(lambda v, *a: flax_model.apply(v, *a, **kw))(
            {"params": params, "batch_stats": stats}, *inputs)
    finally:
        jlayers.FOLD_EVAL_BN = fold
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.fixture(scope="module")
def cli_config(tmp_path_factory):
    """tests/test_torch_train.py's PMF CLI config with mesh_model 2: 4 scans
    a sequence, the global batch 2 × 4 / 2."""
    root = tmp_path_factory.mktemp("split_cli")
    data = make_synthetic_kitti(str(root / "sequences"), n_scans=4, n_points=800)
    for seq in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
        os.symlink(os.path.join(data, "00"), os.path.join(data, f"{seq:02d}"))
    cfg = {"save_path": str(root / "runs"), "seed": 3, "experiment_id": "split", "n_epochs": 1,
           "batch_size": [2, 2], "lr": 0.01, "warmup_epochs": 1, "dataset": "SemanticKitti",
           "nclasses": 20, "data_root": data, "net_type": "PMFNet", "base_channels": 8,
           "compute_dtype": "float32", "mesh_data": -1, "mesh_model": 2,
           "augmentation": {"img_jitter": [0.4, 0.4, 0.4]},
           "sensor": {**CFG, "pcd_aug": False, "img_mean": [12.12, 10.88, 0.23, -1.04, 0.21],
                      "img_stds": [12.32, 11.47, 6.91, 0.86, 0.16]}}
    path = str(root / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


@pytest.fixture(scope="module")
def report(cli_config):
    """One spawn of data 2 × model 2 (`spatial_job`: the split forwards, the
    exchange's gradient check, the PMF train step, the train CLI), while
    this process computes the references: the one-process forwards and
    train step (one thread) and pmf_tpu's sharded forwards."""
    threads = torch.get_num_threads()
    with dryrun.Grid(4, 2, dryrun.spatial_job,
                     (0, [cli_config[0], "--device", "cpu", "--debug"]), timeout_s=300.0) as grid:
        torch.set_num_threads(1)
        try:
            ref = {(net, dt): _unsplit(net, getattr(torch, dt)) for net in NETS
                   for dt in ("float64", "float32")}
            ref["train"] = dryrun.train_step(slice(0, 2 * dryrun.ROWS), 2 * dryrun.ROWS)
            ref["steps"] = {net: dryrun.net_step(net, slice(None)) for net in NETS}
            ref["jax"] = {net: _jax_sharded(net) for net in NETS}
        finally:
            torch.set_num_threads(threads)
        ranks = grid.results()
    assert [r is None for r in ranks] == [False, True, False, True]
    return ref, ranks[0], ranks[2]


def _split_outputs(report, net: str, dtype: str) -> list:
    """The data groups' gathered outputs, batch rows in order."""
    _, g0, g1 = report
    return [np.concatenate([a, b]) for a, b in zip(g0["forward"][net, dtype],
                                                    g1["forward"][net, dtype])]


@pytest.mark.parametrize("net", NETS)
def test_split_forward_equals_unsplit(report, net):
    """Float64 eval forwards at model 2 (the rows of each data group's 2
    samples in two blocks: the convs, pools and resizes across the block
    edge, EPMF's mask pools, SalsaNext's 2×2 dilated convs, EPMF's
    bottleneck of one row, the second block empty) against one process:
    1e-10 relative. A window past a whole block is test_exchange_backward's
    dilation-18 conv."""
    got, want = _split_outputs(report, net, "float64"), report[0][net, "float64"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-10 * np.abs(w).max()


@pytest.mark.parametrize("net", NETS)
def test_split_forward_matches_pmf_tpu_sharded(report, net):
    """Float32 split forwards against pmf_tpu's forward with the rows
    sharded over `model` on the 4×2 CPU mesh: probabilities to 1e-4, argmax
    equal on ≥ 99.5 % of the pixels."""
    got, want = _split_outputs(report, net, "float32"), report[0]["jax"][net]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)
        assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.995


def test_split_train_step_equals_one_process(report):
    """The PMF train step (point Lovász from K1's flags and K2's canvas,
    dropout, the hybrid optimizer) at data 2 × model 2 against the same
    global batch in one process, float64: losses 1e-5, BN statistics 1e-5,
    parameters 1e-5 of their norm, confusion matrices exact."""
    ref, g0, _ = report
    train = dryrun._compare(ref["train"], g0["train"])
    assert train["loss_rel_err"] <= 1e-5
    assert train["stats_abs_err"] <= 1e-5
    assert train["param_rel_err"] <= 1e-5
    assert train["conf_equal"]
    assert np.isfinite(list(train["losses"].values())).all()


@pytest.mark.parametrize("net", NETS)
def test_split_net_steps_equal_one_process(report, net):
    """Each net's train step at data 2 × model 2 (PMFNet with the image
    Lovász over blocks of uneven widths, EPMFNet with the multi-task σ,
    SalsaNext with AdamW) against one process, float64, to the same
    tolerances."""
    ref, g0, g1 = report
    for group in (g0, g1):
        got = dryrun._compare(ref["steps"][net], group["steps"][net])
        assert got["loss_rel_err"] <= 1e-5
        assert got["stats_abs_err"] <= 1e-5
        assert got["param_rel_err"] <= 1e-5
        assert got["conf_equal"]


@pytest.mark.parametrize("rows", [20, 6])
def test_exchange_backward(report, rows):
    """The exchange's backward pass: a chain of split ops (a dilation-18
    conv reaching past the neighbour's whole block, pools, a strided conv,
    the upsample and the pixel shuffle; at 6 rows the last stage has fewer
    rows than ranks) gives the values and the gradients of its input and
    of the conv weights of one process, float64."""
    for group in report[1:]:
        check = group["exchange"][rows]
        assert check["value"] <= 1e-12
        assert check["grad_input"] <= 1e-12
        assert check["grad_weights"] <= 1e-12


def test_train_cli_at_data_2_model_2(report, cli_config):
    """tools/train.py on 4 gloo processes with mesh_model 2: both data
    groups finish the epoch with the same best metrics, and rank 0
    writes the run directory."""
    path, cfg = cli_config
    _, g0, g1 = report
    assert g0["cli"] == g1["cli"] and set(g0["cli"]) == {"Acc", "IOU", "Recall"}
    run_dir = os.path.join(cfg["save_path"], "SemanticKitti-PMFNet-resnet34-bs2-lr0.01-split")
    assert os.path.exists(os.path.join(run_dir, "checkpoint", "checkpoint.pth"))
    log = open(os.path.join(run_dir, "log", "experiment.log")).read()
    assert log.count(">>> Train") == 1 and log.count(">>> Validation") == 1


def test_row_blocks_and_the_height_registry():
    """Blocks are even where M divides H, ceil-split otherwise, the last
    ones short or empty; a split knows the heights of the blocks it made
    and refuses a second height for one (rows, width)."""
    assert [spatial.block_rows(20, 2, m) for m in range(2)] == [(0, 10), (10, 20)]
    assert [spatial.block_rows(5, 2, m) for m in range(2)] == [(0, 3), (3, 5)]
    assert [spatial.block_rows(1, 2, m) for m in range(2)] == [(0, 1), (1, 1)]
    assert [spatial.block_rows(6, 4, m) for m in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 6)]
    mesh = parallel.Mesh(data=1, model=2, rank=1)
    x = torch.zeros(2, 5, 7)
    with mesh.split() as split:
        assert spatial.split_rows(x).shape == (2, 2, 7) and spatial.height(x[:, 3:], 1) == 5
        with pytest.raises(ValueError):
            split.register(2, 7, 4)
    assert spatial.active() is None and spatial.split_rows(x) is x
