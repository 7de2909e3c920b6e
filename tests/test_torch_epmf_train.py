"""The port's EPMF train path against pmf_tpu on the CPU: the multi-task
loss, `pmf_losses` with it, the hybrid optimizer with `mt_sigma`, the EPMF
train step (the V2 train view with pmf_tpu's own draws, EPMFNet in train
mode, both Lovász domains, backward), and the train CLI end to end."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from pmf_tpu import losses as jlosses
from pmf_tpu import models as jmodels
from pmf_tpu import train as jtrain
from pmf_tpu.data import SemanticKitti, kitti_sample_reader
from pmf_tpu.data import perspective_pipeline_v2 as jv2
from pmf_tpu.models.torch_convert import convert_pmf_state_dict
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch import losses as tlosses
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch import train as ttrain
from pmf_tpu_torch.tools import infer_kitti
from pmf_tpu_torch.tools import train as train_cli
from tests.test_data_pipeline import make_synthetic_kitti
from tests.test_torch_epmf import CFG, VIEW_KEYS, _jax_draws
from tests.test_torch_train import _named_grads, _ThreeStreams


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several test processes side by
    side on the cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_multi_task_loss_matches_jax():
    """Value and gradients (w.r.t. σ and each loss) within 1e-5, from σ's
    start ones(6)/6 and from a moved σ."""
    rng = np.random.default_rng(40)
    losses = rng.uniform(0.05, 3, 6).astype(np.float32)
    np.testing.assert_array_equal(tlosses.init_multi_task_params(6).numpy(),
                                  np.asarray(jlosses.init_multi_task_params(6)))
    for sigma in (np.ones(6, np.float32) / 6, rng.uniform(0.2, 2, 6).astype(np.float32)):
        s = torch.tensor(sigma, requires_grad=True)
        ls = [torch.tensor(v, requires_grad=True) for v in losses]
        total = tlosses.multi_task_loss(s, ls)
        total.backward()
        want, (g_s, g_l) = jax.value_and_grad(
            lambda a, b: jlosses.multi_task_loss(a, list(b)), argnums=(0, 1))(
                jnp.asarray(sigma), tuple(jnp.asarray(v) for v in losses))
        np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
        np.testing.assert_allclose(s.grad.numpy(), np.asarray(g_s), rtol=1e-5)
        np.testing.assert_allclose([t.grad.item() for t in ls], np.asarray(g_l), rtol=1e-5)


def test_hybrid_optimizer_with_mt_sigma_matches_optax():
    """Three updates fed the same gradients: `mt_sigma`, given as `extra`,
    takes AdamW's update, as optax routes the `mt_sigma` key; the streams
    as before (within 1e-6)."""
    shapes = {"lidar_stream": {"a": (3, 4)}, "camera_stream_encoder": {"c": (2, 3)}}
    rng = np.random.default_rng(41)
    p0 = {t: {n: rng.normal(size=s).astype(np.float32) for n, s in d.items()}
          for t, d in shapes.items()}
    p0["mt_sigma"] = np.ones(6, np.float32) / 6
    model = _ThreeStreams(shapes)
    sigma = torch.nn.Parameter(torch.from_numpy(p0["mt_sigma"].copy()))
    with torch.no_grad():
        for t, d in shapes.items():
            for n in d:
                getattr(model, t)[n].copy_(torch.from_numpy(p0[t][n]))
    schedule = (ttrain.warmup_cosine_lr(1e-2, 2, 10), jtrain.warmup_cosine_lr(1e-2, 2, 10))
    opt = ttrain.HybridOptimizer(model, schedule[0], 0.9, 1e-4, extra=[sigma])
    tx = jtrain.hybrid_pmf_optimizer(schedule[1], 0.9, 1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda v: rng.normal(size=v.shape).astype(np.float32), p0)
        for t, d in shapes.items():
            for n in d:
                getattr(model, t)[n].grad = torch.from_numpy(g[t][n])
        sigma.grad = torch.from_numpy(g["mt_sigma"])
        opt.step()
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(params["mt_sigma"]),
                                   rtol=1e-6, atol=1e-6, err_msg=f"mt_sigma step {step}")
        for t, d in shapes.items():
            for n in d:
                np.testing.assert_allclose(getattr(model, t)[n].detach().numpy(),
                                           np.asarray(params[t][n]), rtol=1e-6, atol=1e-6)
    assert np.abs(sigma.detach().numpy() - p0["mt_sigma"]).min() > 1e-4


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    root = make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti_epmf_train")), n_points=700)
    read = kitti_sample_reader(SemanticKitti(root, [0]), jv2.V2Config(**CFG), use_native=False)
    scans = [read(i) for i in range(3)]
    return [np.stack([np.asarray(s[k]) for s in scans]) for k in VIEW_KEYS]


@pytest.mark.parametrize("point_lovasz", [True, False])
def test_epmf_train_step_matches_jax(samples, point_lovasz):
    """The slice as a whole, at dropout 0: the V2 train view with pmf_tpu's
    draws, EPMFNet in train mode, `pmf_losses` weighted by the multi-task σ
    with the point-domain or the image-domain Lovász, and backward. Every
    loss term and σ's gradient within 1e-5; each tensor of BN running
    statistics after the forward within 1e-5 of its norm, and each
    parameter gradient within 1e-4 of its norm, or either within 10 times
    pmf_tpu's own move when the batch is reordered (tests/test_torch_train.py
    says why)."""
    cfg_j = jv2.V2Config(**CFG, img_jitter=(0.4, 0.4, 0.4))
    aug = _jax_draws(jax.random.PRNGKey(6), samples, cfg_j, 3)
    f, _, label, points = tdata.build_v2_batch(*map(torch.from_numpy, samples),
                                               tdata.V2Config(**CFG), train=True,
                                               aug_override=aug, return_points=True)
    model = tmodels.random_weights(tmodels.EPMFNet(nclasses=20, base_channels=8,
                                                   dropout_rate=0.0), seed=42).train()
    params, stats = convert_pmf_state_dict(
        {k: v.numpy().copy() for k, v in model.state_dict().items()})
    params["mt_sigma"] = np.random.default_rng(43).uniform(0.1, 1.0, 6).astype(np.float32)
    sigma = torch.tensor(params["mt_sigma"], requires_grad=True)
    alpha = tuple(np.random.default_rng(44).uniform(0.2, 1, 20).astype(np.float32).tolist())
    cfg_t = ttrain.LossConfig(alpha=alpha, use_mtloss=True)
    cfg_jl = jtrain.LossConfig(alpha=alpha, use_mtloss=True)
    pts = points if point_lovasz else None

    lidar, cam = model(f[..., :5], f[..., 5:8])
    total, aux = ttrain.pmf_losses(lidar, cam, label, cfg_t, pts, sigma)
    total.backward()

    jmodel = jmodels.EPMFNet(nclasses=20, base_channels=8, dropout_rate=0.0)

    def loss_fn(p, feature, lab, pt):
        model_params = {k: v for k, v in p.items() if k != "mt_sigma"}
        (lp, cp), mut = jmodel.apply({"params": model_params, "batch_stats": stats},
                                     feature[..., :5], feature[..., 5:8], train=True,
                                     mutable=["batch_stats"])
        tot, jaux = jtrain.steps.pmf_losses(lp, cp, lab, cfg_jl, p["mt_sigma"], pt)
        return tot, (jaux, mut["batch_stats"])

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    batch = [f.numpy(), label.numpy(), *(t.numpy() for t in points)]
    as_pts = lambda arrays: tuple(map(jnp.asarray, arrays)) if point_lovasz else None
    grads, (jaux, jstats) = grad_fn(params, *map(jnp.asarray, batch[:2]), as_pts(batch[2:]))
    reordered = [grad_fn(params, *(jnp.asarray(a[order]) for a in batch[:2]),
                         as_pts([a[order] for a in batch[2:]]))
                 for order in ([2, 0, 1], [1, 2, 0])]
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(sigma.grad.numpy(), np.asarray(grads.pop("mt_sigma")), rtol=1e-5)
    for r, _ in reordered:
        r.pop("mt_sigma")
    _, new_stats = convert_pmf_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    got = _named_grads(model)
    # each tensor within `tol` of its norm, or 10 times pmf_tpu's own move
    # (the deepest BN sees 8 pixels a scan at 1/32 resolution, so its
    # float32 statistics move in the fifth digit with the order of the sums)
    for tol, mine, want, others in ((1e-5, new_stats, jstats, [r[1][1] for r in reordered]),
                                    (1e-4, got, grads, [r[0] for r in reordered])):
        assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
        paths = jax.tree_util.tree_flatten_with_path(mine)[0]
        for (path, a), w, *rest in zip(paths, *map(jax.tree_util.tree_leaves, [want, *others])):
            w = np.asarray(w)
            err, norm = np.linalg.norm(a - w), np.linalg.norm(w)
            noise = max(np.linalg.norm(np.asarray(o) - w) for o in rest)
            assert err <= max(tol * norm + 1e-7, 10 * noise), \
                (jax.tree_util.keystr(path), err, noise, norm)


@pytest.fixture(scope="module")
def cli_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("epmf_train_cli")
    data = make_synthetic_kitti(str(root / "sequences"), n_scans=2, n_points=800)
    for seq in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
        os.symlink(os.path.join(data, "00"), os.path.join(data, f"{seq:02d}"))
    cfg = {
        "save_path": str(root / "runs"), "seed": 3, "experiment_id": "cli",
        "n_epochs": 2, "batch_size": [2, 2], "lr": 0.01, "warmup_epochs": 1,
        "dataset": "SemanticKitti", "nclasses": 20, "data_root": data,
        "net_type": "EPMFNet", "base_channels": 8, "img_backbone": "resnet34",
        "compute_dtype": "float32", "lambda": 1.0, "gamma": 0.5, "tau": 0.7,
        "use_mtloss": True, "point_lovasz": False,
        "cls_freq": np.random.default_rng(45).integers(1, 10**6, 20).tolist(),
        "augmentation": {"img_jitter": [0.4, 0.4, 0.4]},
        "PVconfig": {**CFG, "pcd_mean": [12.12, 10.88, 0.23, -1.04, 0.21],
                     "pcd_stds": [12.32, 11.47, 6.91, 0.86, 0.16]},
    }
    path = str(root / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def test_train_cli_epmf_writes_checkpoints_that_infer_kitti_loads(cli_config):
    """`tools/train.py --device cpu --debug` on an EPMF config with the
    multi-task loss and the image-domain Lovász: σ trains and is saved in
    the resume checkpoint and beside the last snapshot's model tensors; the
    snapshot loads through the eval CLI; a resumed run restores σ."""
    path, cfg = cli_config
    best = train_cli.main([path, "--device", "cpu", "--debug"])
    assert set(best) == {"Acc", "IOU", "Recall"}
    ckpt = os.path.join(cfg["save_path"], "SemanticKitti-EPMFNet-resnet34-bs2-lr0.01-cli",
                        "checkpoint")
    state = torch.load(os.path.join(ckpt, "checkpoint.pth"), weights_only=True)
    assert state["epoch"] == 1 and state["optimizer"]["steps"] == 2
    sigma = state["mt_sigma"]
    assert sigma.shape == (6,) and (sigma - 1 / 6).abs().min() > 0
    snapshot = os.path.join(ckpt, "best_last_model.pth")
    assert torch.equal(torch.load(snapshot, weights_only=True)["mt_sigma"], sigma)
    out = infer_kitti.main([path, "--weights", snapshot, "--max-scans", "1", "--device", "cpu"])
    assert np.isfinite(out["point"]["mIoU"])

    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, checkpoint=True, n_epochs=3), f)
    from pmf_tpu_torch.config import load_options

    opts = load_options(path)
    trainer = ttrain.Trainer.from_files(opts, tmodels.build_model(opts), torch.device("cpu"))
    assert trainer.loss_cfg.use_mtloss and not trainer.point_lovasz
    np.testing.assert_array_equal(trainer.loss_cfg.alpha,
                                  ttrain.config_focal_alpha(cfg["cls_freq"]))
    experiment = train_cli.Experiment(opts, trainer)
    assert experiment.start_epoch == 2 and torch.equal(trainer.mt_sigma.detach(), sigma)
