"""The port's SalsaNext train and eval path against pmf_tpu on the CPU:
`salsanext_losses` (values and gradients), `adamw` against optax, the
SalsaNext train step's gradients on the range view, `build_model`, the
train CLI end to end (its snapshot loaded by the SalsaNext eval CLI), and
the eval CLI against pmf_tpu's `SalsaNextInference` on the same weights.
Inputs are made from numpy seeds; dropout is off where the two packages are
compared, since they draw other random numbers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from pmf_tpu import models as jmodels
from pmf_tpu import train as jtrain
from pmf_tpu.config import load_options as jload_options
from pmf_tpu.models.torch_convert import convert_generic_state_dict
from pmf_tpu.train.optim import adamw as jax_adamw
from pmf_tpu.tools import infer_salsanext as jinfer
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch import train as ttrain
from pmf_tpu_torch.config import load_options
from pmf_tpu_torch.tools import infer_salsanext
from pmf_tpu_torch.tools import train as train_cli
from tests.test_data_pipeline import make_synthetic_kitti
from tests.test_torch_infer_kitti import _labels
from tests.test_torch_losses import TOL, probs
from tests.test_torch_range import SALSANEXT_KITTI, scans
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W = 16, 128


def _numpy_sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def test_salsanext_losses_match_jax():
    """focal (labelled pixels) + λ·lovász, each term and the gradient of the
    total with respect to the probabilities within 1e-5."""
    rng = np.random.default_rng(40)
    p = probs(41, (2, H, W))
    label = rng.integers(0, 20, (2, H, W)).astype(np.int32)
    label[:, :4] = 0
    alpha = tuple(rng.uniform(0.1, 1, 20).astype(np.float32).tolist())
    cfg_t = ttrain.LossConfig(alpha=alpha, lambda_=0.7)
    cfg_j = jtrain.LossConfig(alpha=alpha, lambda_=0.7)
    x = torch.from_numpy(p).requires_grad_()
    total, aux_t = ttrain.salsanext_losses(x, torch.from_numpy(label), cfg_t)
    total.backward()
    (want, aux_j), grad = jax.jit(jax.value_and_grad(
        lambda y: jtrain.steps.salsanext_losses(y, jnp.asarray(label), cfg_j), has_aux=True))(p)
    np.testing.assert_allclose(total.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), **TOL)
    assert set(aux_t) == set(aux_j) == {"loss", "loss_focal", "loss_lovasz"}
    for k, v in aux_j.items():
        np.testing.assert_allclose(aux_t[k].item(), float(v), **TOL, err_msg=k)


def test_adamw_matches_optax():
    """Three updates of `adamw` (every parameter, weight decay 0.01) fed
    the same gradients as pmf_tpu's optax adamw, through a warmup whose
    first learning rate is 0: within 1e-6; its state reloads."""
    rng = np.random.default_rng(42)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    p0 = {k: v.detach().numpy().copy() for k, v in model.named_parameters()}
    schedule_t, schedule_j = (m.warmup_cosine_lr(1e-2, 2, 10) for m in (ttrain, jtrain))
    opt = ttrain.adamw(model, schedule_t)
    tx = jax_adamw(schedule_j)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    update = jax.jit(lambda g, state, params: tx.update(g, state, params))
    for step in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} step {step}")
    assert min(np.abs(np.asarray(params[k]) - p0[k]).max() for k in p0) > 1e-4
    opt2 = ttrain.adamw(model, schedule_t)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.steps == 3 and opt2.lr == opt.lr and set(opt.state_dict()) == {"steps", "adamw"}


def test_salsanext_train_step_gradients_match_jax():
    """The slice as a whole, at dropout 0: the range view of two scans
    (K1's plain version), SalsaNext in train mode, `salsanext_losses` and
    backward. Every loss term within 1e-5, the BN running statistics after
    the forward within 1e-5, and each parameter gradient within 1e-4 of its
    norm, or, where pmf_tpu moves more than that between the batch and two
    reorderings of it, 10 times its larger move (tests/test_torch_train.py
    says why). Then `make_salsanext_train_step` with `adamw` moves the
    parameters, and its confusion matrix counts every pixel."""
    pts, labels, valid = scans(43, 3, 4096)
    cfg = tdata.RangeConfig(proj_h=H, proj_w=W, n_points=4096)
    f, label, _ = tdata.build_range_batch(*map(torch.from_numpy, (pts, labels, valid)), cfg)
    model = tmodels.random_weights(tmodels.SalsaNext(nclasses=20, base_channels=8,
                                                     dropout_rate=0.0), seed=44).train()
    params, stats = convert_generic_state_dict(_numpy_sd(model))
    alpha = tuple(np.random.default_rng(45).uniform(0.2, 1, 20).astype(np.float32).tolist())
    cfg_t, cfg_j = ttrain.LossConfig(alpha=alpha), jtrain.LossConfig(alpha=alpha)

    total, aux = ttrain.salsanext_losses(model(f), label, cfg_t)
    total.backward()

    jmodel = jmodels.SalsaNext(nclasses=20, base_channels=8, dropout_rate=0.0)

    def loss_fn(p, feature, lab):
        pred, mut = jmodel.apply({"params": p, "batch_stats": stats}, feature, train=True,
                                 mutable=["batch_stats"])
        tot, jaux = jtrain.steps.salsanext_losses(pred, lab, cfg_j)
        return tot, (jaux, mut["batch_stats"])

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    batch = [f.numpy(), label.numpy()]
    grads, (jaux, jstats) = grad_fn(params, *map(jnp.asarray, batch))
    reordered = [grad_fn(params, *(jnp.asarray(a[order]) for a in batch))[0]
                 for order in ([2, 0, 1], [1, 2, 0])]
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5, err_msg=k)
    _, new_stats = convert_generic_state_dict(_numpy_sd(model))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(new_stats)[0],
                            jax.tree_util.tree_leaves(jstats)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    sd.update({k: p.grad for k, p in model.named_parameters()})
    got = convert_generic_state_dict({k: v.numpy() for k, v in sd.items()})[0]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(grads)
    paths = jax.tree_util.tree_flatten_with_path(got)[0]
    for (path, g), w, *others in zip(paths, *map(jax.tree_util.tree_leaves, [grads, *reordered])):
        w = np.asarray(w)
        err, norm = np.linalg.norm(g - w), np.linalg.norm(w)
        noise = max(np.linalg.norm(np.asarray(o) - w) for o in others)
        assert err <= max(1e-4 * norm, 10 * noise) + 1e-7, \
            (jax.tree_util.keystr(path), err, noise, norm)
    # at 16 rows the deepest block sees one row, where the 2x2 dilation-2
    # conv reads only its padding: its kernel's gradient is 0, in pmf_tpu too
    zero = [jax.tree_util.keystr(p) for p, g in paths if not np.abs(g).any()]
    assert zero == ["['resBlock5']['conv4']['Conv_0']['kernel']"]
    assert not np.asarray(grads["resBlock5"]["conv4"]["Conv_0"]["kernel"]).any()

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = ttrain.make_salsanext_train_step(model, ttrain.adamw(model, lambda s: 1e-3), cfg_t)
    out = step(f, label)
    assert out["conf"].sum() == label.numel() and torch.isfinite(out["loss"])
    assert all(not torch.equal(before[k], p) for k, p in model.named_parameters())


def test_build_model_salsanext_kitti():
    model = tmodels.build_model(load_options(SALSANEXT_KITTI))
    assert isinstance(model, tmodels.SalsaNext) and model.dtype == torch.float32
    assert model.downCntx.conv1.in_channels == 5 and model.logits.in_channels == 32


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A synthetic SemanticKITTI tree (sequence 00 linked as 01-10) and a
    small SalsaNext config with salsanext_kitti.yaml's augmentation."""
    root = tmp_path_factory.mktemp("salsanext_cli")
    data = make_synthetic_kitti(str(root / "sequences"), n_scans=2, n_points=800)
    for seq in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
        os.symlink(os.path.join(data, "00"), os.path.join(data, f"{seq:02d}"))
    shipped = yaml.safe_load(open(SALSANEXT_KITTI))
    cfg = {
        "save_path": str(root / "runs"), "seed": 3, "experiment_id": "cli",
        "n_epochs": 2, "batch_size": [2, 2], "lr": 0.01, "warmup_epochs": 1,
        "dataset": "SemanticKitti", "nclasses": 20, "data_root": data,
        "net_type": "SalsaNext", "base_channels": 8, "lambda": 1.0,
        "augmentation": shipped["augmentation"],
        "sensor": {**shipped["sensor"], "proj_h": H, "proj_w": W, "n_points": 1024},
        "post": shipped["post"],
    }
    path = str(root / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return root, path, cfg


def test_train_cli_salsanext_snapshot_loads_in_infer_salsanext(cli_setup):
    """`tools/train.py --device cpu --debug` with `net_type: SalsaNext`: a
    resume checkpoint and best snapshots; the last snapshot loads through
    `tools/infer_salsanext.py --knn`; a run with `checkpoint` set resumes
    after the saved epoch; without a card the default device raises."""
    root, path, cfg = cli_setup
    best = train_cli.main([path, "--device", "cpu", "--debug"])
    assert set(best) == {"Acc", "IOU", "Recall"}
    run_dir = os.path.join(cfg["save_path"], "SemanticKitti-SalsaNext-resnet34-bs2-lr0.01-cli")
    ckpt = os.path.join(run_dir, "checkpoint")
    snapshot = os.path.join(ckpt, "best_last_model.pth")
    assert os.path.exists(os.path.join(ckpt, "checkpoint.pth")) and os.path.exists(snapshot)
    log = open(os.path.join(run_dir, "log", "experiment.log")).read()
    assert log.count(">>> Train") == 2 and log.count(">>> Validation") == 2
    assert "ImgAcc" not in log and "Entropy" not in log

    preds = str(root / "preds_cli")
    out = infer_salsanext.main([path, "--weights", snapshot, "--knn", "--max-scans", "1",
                                "--save-preds", preds, "--device", "cpu"])
    assert np.isfinite(out["mIoU"]) and _labels(preds)[0].shape == (800,)

    state = torch.load(os.path.join(ckpt, "checkpoint.pth"), weights_only=True)
    assert state["epoch"] == 1 and state["optimizer"]["steps"] == 2
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, checkpoint=True, n_epochs=3), f)
    try:
        train_cli.main([path, "--device", "cpu", "--debug"])
    finally:
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
    state = torch.load(os.path.join(ckpt, "checkpoint.pth"), weights_only=True)
    assert state["epoch"] == 2 and state["optimizer"]["steps"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_cli.main([path])
        with pytest.raises(RuntimeError):
            infer_salsanext.main([path, "--weights", snapshot])


def test_infer_salsanext_matches_jax(cli_setup, tmp_path):
    """The eval CLI (the per-scan range view, SalsaNext, the KNN lift, point
    IoU) against pmf_tpu's SalsaNextInference on the same weights, given to
    the port as the flat flax tree that models/convert.py reads: per-point
    predictions on >= 99.5 % of the points, mIoU within 0.002. The `.pth`
    of the same weights gives the same predictions."""
    from pmf_tpu.train.checkpoint import CheckpointManager

    root, path, _ = cli_setup
    model = tmodels.random_weights(tmodels.SalsaNext(nclasses=20, base_channels=8), seed=46)
    params, stats = convert_generic_state_dict(_numpy_sd(model))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save_best({"params": params, "batch_stats": stats}, "IOU")
    jax_preds = str(tmp_path / "preds_jax")
    jax_out = jinfer.SalsaNextInference(jload_options(path), os.path.join(ckpt.directory,
                                                                          "best_IOU_model"),
                                        use_knn=True, save_preds=jax_preds).run()
    npz = str(tmp_path / "w.npz")
    flat = {"/".join([top] + [k.key for k in keys]): leaf
            for top, tree in (("params", params), ("batch_stats", stats))
            for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(npz, **flat)
    pth = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), pth)
    runs = []
    for weights in (npz, pth):
        preds = str(tmp_path / f"preds_{len(runs)}")
        runs.append((infer_salsanext.main([path, "--weights", weights, "--knn", "--save-preds",
                                           preds, "--device", "cpu"]), _labels(preds)))
    (out, got), (_, got_pth) = runs
    want = _labels(jax_preds)
    assert len(got) == len(want) == 2
    for g, w, p in zip(got, want, got_pth):
        assert g.shape == w.shape == (800,)
        assert (g == w).mean() >= 0.995
        np.testing.assert_array_equal(g, p)
    assert abs(out["mIoU"] - jax_out["mIoU"]) <= 0.002 and np.isfinite(out["mIoU"])
    assert len(np.unique(np.concatenate(got))) > 2
