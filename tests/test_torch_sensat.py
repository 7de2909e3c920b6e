"""The port's SensatUrban slice against pmf_tpu on the CPU: PLY IO and the
BEV rasterization, the frames, tiles and frame weights, the readers,
`build_sensat_batch` (eval; train with pmf_tpu's own draws, the batched
redraws against a sequential loop), the test-time views, the Dice losses
and `pmf_losses` with them, AMSGrad against optax, the eval CLI
(`SensatInference` with TTA and with KNN) and the trainer's data with one
debug `tools/train.py` run. The frames are `tests/test_sensat.py:
sensat_root` (2 train and 2 val blocks of 3000 points, 80 x 60 cells)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from pmf_tpu import losses as jlosses
from pmf_tpu import train as jtrain
from pmf_tpu.config import load_options as jload_options
from pmf_tpu.data import loader as jloader
from pmf_tpu.data import sensat_urban as jsensat
from pmf_tpu.tools import infer_sensat as jinfer
from pmf_tpu_torch import losses as tlosses
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch import train as ttrain
from pmf_tpu_torch.config import load_options
from pmf_tpu_torch.data import loader as tloader
from pmf_tpu_torch.data import sensat_urban as tsensat
from pmf_tpu_torch.tools import infer_sensat
from pmf_tpu_torch.tools import train as train_cli
from pmf_tpu_torch.train import Trainer
from tests.test_sensat import sensat_root  # noqa: F401 (a fixture)
from tests.test_torch_a2d2 import _jax_trainer_data, jax_cli_weights
from tests.test_torch_train import _ThreeStreams


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several test processes side by
    side on the cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ply_and_bev_feature_match_jax(tmp_path):
    """Each package reads the other's PLY; `compute_bev_feature` on a cloud
    with ties in z and several points a cell: every output exactly."""
    rng = np.random.default_rng(20)
    n = 5000
    fields = {"x": rng.uniform(0, 4, n).astype(np.float32),
              "y": rng.uniform(0, 3, n).astype(np.float32),
              "z": rng.integers(0, 40, n).astype(np.float32) / 4,    # ties in z
              "red": rng.integers(0, 255, n).astype(np.uint8),
              "green": rng.integers(0, 255, n).astype(np.uint8),
              "blue": rng.integers(0, 255, n).astype(np.uint8),
              "class": rng.integers(0, 13, n).astype(np.uint8)}
    for write, read, name in ((tsensat.write_ply, jsensat.read_ply, "a.ply"),
                              (jsensat.write_ply, tsensat.read_ply, "b.ply")):
        write(str(tmp_path / name), fields)
        back = read(str(tmp_path / name))
        for k, v in fields.items():
            np.testing.assert_array_equal(back[k], v)
            assert back[k].dtype == v.dtype
    pc = np.stack([fields[k] for k in fields], 1).astype(np.float64)
    got, want = tsensat.compute_bev_feature(pc), jsensat.compute_bev_feature(pc)
    assert got.keys() == want.keys() and got["feature_map"].shape == (8, 30, 40)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype


def test_frames_tiles_and_weights_match_jax(sensat_root, tmp_path):  # noqa: F811
    """The train frames with their cells, the val frames tiled at 32 x 32
    (padding label 0), a .pth frame, the file names and labels, and the
    frame weights: exactly as pmf_tpu's."""
    for split, kw in (("train", {"keep_idx": True}),
                      ("val", {"img_h": 32, "img_w": 32, "use_crop": True})):
        got, want = tsensat.SensatUrban(sensat_root, split, **kw), \
            jsensat.SensatUrban(sensat_root, split, **kw)
        assert len(got) == len(want) and got.data_split == want.data_split
        for i in range(len(got)):
            g, w = got.readDataByIndex(i), want.readDataByIndex(i)
            assert g.keys() == w.keys()
            for k in g:
                if w[k] is None:
                    assert g[k] is None
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert tsensat.sensat_frame_weights(got, 200) == jsensat.sensat_frame_weights(want, 200)
    assert len(got) == 12
    small = {k: v[:, :20, :20] if v.ndim == 3 else v[:20, :20] for k, v in
             got.readDataByIndex(0).items()}       # a frame smaller than a tile: padded
    for g, w in zip(tsensat._tile_frame(small, 32, 32), jsensat._tile_frame(small, 32, 32)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert (g["label_map"][20:] == 0).all() and (g["label_map"][:20, :20] == -1).any()
    assert got.readFileNameByIndex(0) == "block_0.bin"
    np.testing.assert_array_equal(tsensat.SensatUrban(sensat_root, "val").readLabelByIndex(1),
                                  jsensat.SensatUrban(sensat_root, "val").readLabelByIndex(1))
    os.makedirs(tmp_path / "test")
    frame = tsensat.SensatUrban(sensat_root, "train", keep_idx=True).readDataByIndex(0)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in frame.items()},
               str(tmp_path / "test" / "block_9.pth"))
    torch.save(frame, str(tmp_path / "test" / "cambridge_block_1.pth"))   # left out
    g, w = (m.SensatUrban(str(tmp_path), "test", keep_idx=True) for m in (tsensat, jsensat))
    assert len(g) == len(w) == 1
    for k in ("feature_map", "label_map"):
        np.testing.assert_array_equal(g.readDataByIndex(0)[k], w.readDataByIndex(0)[k])
    with pytest.raises(ValueError):
        tsensat.SensatUrban(str(tmp_path), "other")


def test_readers_match_jax(sensat_root):  # noqa: F811
    """The train reader's (2h, 2w) windows from a RandomState(s) against
    pmf_tpu's reader after np.random.seed(s), through the frame weights;
    the eval reader's tiles."""
    cfg = tsensat.SensatConfig(img_h=24, img_w=24)
    train = tsensat.SensatUrban(sensat_root, "train")
    weights = tsensat.sensat_frame_weights(train, 200)
    read_t = tloader.sensat_sample_reader(train, cfg, weights, rng=np.random.RandomState(7))
    read_j = jloader.sensat_sample_reader(jsensat.SensatUrban(sensat_root, "train"), cfg, weights)
    np.random.seed(7)
    for i in (0, 1, 2, 1):
        g, w = read_t(i), read_j(i)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert g["feature_map"].shape == (8, 48, 48) and (g["label_map"] == -1).any()
    val = tsensat.SensatUrban(sensat_root, "val", img_h=32, img_w=32, use_crop=True)
    g = tloader.sensat_sample_reader(val, cfg, train=False)(3)
    w = jloader.sensat_sample_reader(val, cfg, train=False)(3)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError):
        tloader.sensat_sample_reader(train, cfg, weights)


@pytest.fixture(scope="module")
def windows(sensat_root):  # noqa: F811
    """Four train windows of 48 x 48 cells as the train reader cuts them
    (labels -1 past a frame's edge): feature_map [4, 8, 48, 48], label_map
    [4, 48, 48]."""
    cfg = tsensat.SensatConfig(img_h=24, img_w=24)
    read = tloader.sensat_sample_reader(tsensat.SensatUrban(sensat_root, "train"), cfg,
                                        [0, 1, 1, 0], rng=np.random.RandomState(3))
    samples = [read(i) for i in range(4)]
    return [np.stack([s[k] for s in samples]) for k in ("feature_map", "label_map")]


def _jax_draws(key, B, Hf, Wf, cfg):
    """pmf_tpu's draws in `build_sensat_batch` for each sample of a batch,
    made from `key` as it makes them (the key split four ways, then a chain
    of splits, one an attempt), under jit: SensatAugParams [B, A] / [B]."""
    h, w = cfg.img_h, cfg.img_w

    @jax.jit
    def draw(k):
        k0, sub0, kj1, kj2 = jax.random.split(k, 4)
        subs = [sub0]
        for _ in range(cfg.max_resample):
            k0, sub = jax.random.split(k0)
            subs.append(sub)
        per = []
        for s in subs:
            k1, k2, k3, k4, k5 = jax.random.split(s, 5)
            per.append((jax.random.uniform(k1, minval=-jnp.pi, maxval=jnp.pi),
                        jax.random.randint(k2, (), 0, max(Hf - h, 0) + 1),
                        jax.random.randint(k3, (), 0, max(Wf - w, 0) + 1),
                        jax.random.uniform(k4) < 0.5, jax.random.uniform(k5) < 0.5))
        return (*(jnp.stack([p[i] for p in per]) for i in range(5)),
                jax.random.uniform(kj1, minval=-0.2, maxval=0.2),
                jax.random.uniform(kj2, minval=-2.0, maxval=2.0))

    draws = [draw(k) for k in jax.random.split(key, B)]
    out = [torch.from_numpy(np.stack([np.asarray(d[i]) for d in draws])) for i in range(7)]
    out[1], out[2] = out[1].long(), out[2].long()
    return tsensat.SensatAugParams(*out)


def test_build_sensat_batch_eval_matches_jax(windows):
    fm, lm = windows
    cfg = tsensat.SensatConfig(img_h=48, img_w=48)
    f, lab = tsensat.build_sensat_batch(torch.from_numpy(fm), torch.from_numpy(lm), cfg, False)
    fj, lj = jsensat.build_sensat_batch(jax.random.PRNGKey(0), jnp.asarray(fm), jnp.asarray(lm),
                                        jsensat.SensatConfig(img_h=48, img_w=48), False)
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lj))
    assert f.shape == (4, 48, 48, 8) and lab.dtype == torch.int32 and (lab > 0).any()


def test_build_sensat_batch_train_matches_jax(windows):
    """The train crop with pmf_tpu's draws, against its jitted function
    with the while loop: features and labels bit for bit. At min_valid 0.45
    (near the windows' occupied share) the loop takes 1 to 4 attempts. (A
    rotated source within an ulp of a half pixel could round the other way
    under XLA's FMA contraction; no such cell occurs on these draws.)"""
    fm, lm, min_valid = *windows, 0.45
    key = jax.random.PRNGKey(21)
    cfg = tsensat.SensatConfig(img_h=24, img_w=24, min_valid=min_valid)
    aug = _jax_draws(key, 4, 48, 48, cfg)
    f, lab = tsensat.build_sensat_batch(torch.from_numpy(fm), torch.from_numpy(lm), cfg, True,
                                        aug_override=aug)
    fj, lj = jsensat.build_sensat_batch(key, jnp.asarray(fm), jnp.asarray(lm),
                                        jsensat.SensatConfig(img_h=24, img_w=24,
                                                             min_valid=min_valid), True)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
    assert f.shape == (4, 24, 24, 8) and (f[..., 5:8][f[..., 4] == 0] == 0).all()
    attempts = _sequential(*map(torch.from_numpy, windows), cfg, aug)[1]
    assert min(attempts) == 1 < max(attempts)


def _sequential(fm, lm, cfg, aug):
    """The redraw loop one attempt at a time: attempt a of sample b through
    a one-attempt config, kept once its labelled share reaches min_valid
    (on reader windows a cell is labelled where it is occupied), else the
    next, up to the last."""
    one = tsensat.SensatConfig(img_h=cfg.img_h, img_w=cfg.img_w, max_resample=0)
    outs, attempts = [], []
    for b in range(fm.shape[0]):
        for a in range(1 + cfg.max_resample):
            pick = tsensat.SensatAugParams(*(t[b:b + 1, a:a + 1] for t in aug[:5]),
                                           aug.rgb[b:b + 1], aug.height[b:b + 1])
            f, lab = tsensat.build_sensat_batch(fm[b:b + 1], lm[b:b + 1], one, True,
                                                aug_override=pick)
            if (lab > 0).float().mean() >= cfg.min_valid:
                break
        outs.append((f, lab))
        attempts.append(a + 1)
    return [torch.cat(t) for t in zip(*outs)], attempts


def test_batched_redraws_equal_the_sequential_loop(windows):
    """All 1 + max_resample attempts in one gather, the first passing one
    picked on the device, against the loop that tries one attempt after
    another; with draws from a generator, at a min_valid that some
    samples never reach."""
    fm, lm = map(torch.from_numpy, windows)
    seen = set()
    for min_valid, seed in ((0.45, 1), (0.5, 2), (0.9, 3)):
        cfg = tsensat.SensatConfig(img_h=24, img_w=24, min_valid=min_valid)
        aug = tsensat.draw_sensat_aug(torch.Generator().manual_seed(seed), 4, 48, 48, cfg)
        *got, taken = tsensat.build_sensat_batch(fm, lm, cfg, True, aug_override=aug,
                                                 return_attempts=True)
        want, attempts = _sequential(fm, lm, cfg, aug)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert taken.tolist() == attempts
        seen.update(attempts)
    assert attempts == [11] * 4 and 1 in seen     # the last attempt, and the first
    again = tsensat.build_sensat_batch(fm, lm, cfg, True, torch.Generator().manual_seed(3))
    torch.testing.assert_close(list(again), got, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tsensat.build_sensat_batch(fm, lm, cfg, True)


def test_tta_views_match_jax():
    """Each test-time view and its inverse on a non-square HWC window, as
    jnp.rot90(x, k, (0, 1)) and the flips act on it (the direction of the
    rotations shows); each inverse undoes its view."""
    x = np.random.default_rng(4).normal(size=(5, 7, 3)).astype(np.float32)
    for (name, view, inv), (jname, jview, jinv) in zip(infer_sensat.TTA_OPS, jinfer._TTA_OPS):
        assert name == jname
        v = view(torch.from_numpy(x))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jview(jnp.asarray(x))))
        np.testing.assert_array_equal(inv(v).numpy(), x)
        np.testing.assert_array_equal(inv(v).numpy(), np.asarray(jinv(jview(jnp.asarray(x)))))
    assert np.array_equal(infer_sensat.TTA_OPS[1][1](torch.from_numpy(x)).numpy(),
                          np.rot90(x, 1, (0, 1)))


def test_dice_losses_match_jax():
    """dice_loss (the coefficient) and explog_dice_loss with and without a
    mask: values and gradients within 1e-5."""
    rng = np.random.default_rng(22)
    logits = rng.normal(size=(2, 6, 5, 14)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    label = rng.integers(0, 14, (2, 6, 5)).astype(np.int32)
    for mask in (None, label > 0):
        for tfn, jfn in ((tlosses.dice_loss, jlosses.dice_loss),
                         (tlosses.explog_dice_loss, jlosses.explog_dice_loss)):
            p = torch.tensor(probs, requires_grad=True)
            got = tfn(p, torch.from_numpy(label), None if mask is None else torch.from_numpy(mask))
            got.backward()
            want, grad = jax.value_and_grad(lambda q: jfn(q, jnp.asarray(label), mask))(
                jnp.asarray(probs))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-7)


def test_pmf_losses_with_dice_match_jax():
    """`pmf_losses` with use_dice (ExpLogDice added to both focal terms, the
    image-domain Lovász): every term and the gradients w.r.t. both
    streams' probabilities within 1e-5."""
    rng = np.random.default_rng(23)
    streams = []
    for _ in range(2):
        z = rng.normal(size=(2, 8, 6, 14)).astype(np.float32)
        streams.append(np.exp(z) / np.exp(z).sum(-1, keepdims=True))
    label = rng.integers(0, 14, (2, 8, 6)).astype(np.int32)
    alpha = tuple(float(a) for a in ttrain.sensat_focal_alpha(14))
    cfg_t = ttrain.LossConfig(nclasses=14, alpha=alpha, use_dice=True)
    cfg_j = jtrain.steps.LossConfig(nclasses=14, alpha=alpha, use_dice=True)
    lp, cp = (torch.tensor(s, requires_grad=True) for s in streams)
    total, aux = ttrain.pmf_losses(lp, cp, torch.from_numpy(label), cfg_t)
    total.backward()
    (tot, jaux), grads = jax.jit(jax.value_and_grad(
        lambda a, b: jtrain.steps.pmf_losses(a, b, jnp.asarray(label), cfg_j), argnums=(0, 1),
        has_aux=True))(*map(jnp.asarray, streams))
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5, err_msg=k)
    for t, g in zip((lp, cp), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)
    plain = ttrain.pmf_losses(lp, cp, torch.from_numpy(label),
                              ttrain.LossConfig(nclasses=14, alpha=alpha))[1]
    assert aux["loss_focal"] > plain["loss_focal"]


def _amsgrad_optax(lr, p0, grads):
    tx = jtrain.adamw_amsgrad(lambda step: lr)
    params = jnp.asarray(p0)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    return np.asarray(params)


def test_amsgrad_matches_optax_where_torch_amsgrad_does_not():
    """`AMSGradW` against optax's scale_by_amsgrad → add_decayed_weights →
    scale_by_learning_rate over 5 steps to 1e-6, on gradients that shrink
    (10, then 0.1): there torch's AdamW(amsgrad=True), which bias-corrects
    the maximum of the raw second moment, lands a third of an update away."""
    p0 = np.array([0.5, -1.0, 2.0], np.float32)
    grads = [np.full(3, 10.0, np.float32)] + [np.full(3, 0.1, np.float32)] * 4
    want = _amsgrad_optax(1e-3, p0, grads)
    for opt_cls, held in ((ttrain.AMSGradW, True),
                          (lambda ps, lr: torch.optim.AdamW(ps, lr=lr, amsgrad=True), False)):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = opt_cls([p], 1e-3)
        for g in grads:
            p.grad = torch.from_numpy(g)
            opt.step()
        err = np.abs(p.detach().numpy() - want).max()
        assert (err <= 1e-6) if held else (err > 1e-4), (opt_cls, err)


def test_hybrid_optimizer_with_amsgrad_matches_optax():
    """The hybrid optimizer with amsgrad (AMSGrad on the lidar stream, SGD
    with Nesterov momentum on the camera streams), through a warmup whose
    first learning rate is 0, over 5 steps with random gradients: within
    1e-6 of pmf_tpu's `hybrid_pmf_optimizer(amsgrad=True)`; its state
    round-trips."""
    shapes = {"lidar_stream": {"a": (3, 4), "b": (5,)},
              "camera_stream_encoder": {"c": (2, 3)}, "camera_stream_decoder": {"d": (4,)}}
    rng = np.random.default_rng(24)
    p0 = {t: {n: rng.normal(size=s).astype(np.float32) for n, s in d.items()}
          for t, d in shapes.items()}
    model = _ThreeStreams(shapes)
    with torch.no_grad():
        for t, d in p0.items():
            for n, v in d.items():
                getattr(model, t)[n].copy_(torch.from_numpy(v))
    opt = ttrain.HybridOptimizer(model, ttrain.warmup_cosine_lr(1e-2, 2, 10), 0.9, 1e-4,
                                 amsgrad=True)
    assert isinstance(opt.optimizers["adamw"], ttrain.AMSGradW)
    tx = jtrain.hybrid_pmf_optimizer(jtrain.warmup_cosine_lr(1e-2, 2, 10), 0.9, 1e-4,
                                     amsgrad=True)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    for step in range(5):
        scale = 10.0 if step == 1 else 0.1        # the second moment's maximum matters
        g = jax.tree_util.tree_map(
            lambda v: (rng.normal(size=v.shape) * scale).astype(np.float32), p0)
        for t, d in g.items():
            for n, v in d.items():
                getattr(model, t)[n].grad = torch.from_numpy(v)
        opt.step()
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        for t, d in params.items():
            for n, v in d.items():
                np.testing.assert_allclose(getattr(model, t)[n].detach().numpy(), np.asarray(v),
                                           rtol=1e-6, atol=1e-6, err_msg=f"{t}.{n} step {step}")
    opt2 = ttrain.HybridOptimizer(model, ttrain.warmup_cosine_lr(1e-2, 2, 10), 0.9, 1e-4,
                                  amsgrad=True)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.steps == 5 and opt2.optimizers["adamw"].state_dict()["state"][0]["step"] == 5


def _config(root, tmp_path, **kw):
    cfg = {"save_path": str(tmp_path / "exp"), "seed": 1, "n_epochs": 1, "batch_size": [2, 2],
           "lr": 0.001, "warmup_epochs": 1, "dataset": "SensatUrban", "nclasses": 14,
           "data_root": root, "net_type": "PMFNet", "base_channels": 8,
           "img_backbone": "resnet34", "experiment_id": "sensat",
           "sensor": {"proj_h": 32, "proj_w": 32, "proj_ht": 32, "proj_wt": 32,
                      "n_samples_split": 200},
           "post": {"KNN": {"params": {"knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}},
           "augmentation": {}, **kw}
    path = str(tmp_path / "sensat.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _labels(d):
    return {n: np.fromfile(os.path.join(d, n), np.uint8) for n in sorted(os.listdir(d))}


def test_infer_cli_matches_jax(sensat_root, tmp_path):  # noqa: F811
    """`infer_sensat` on the first val frame at one scale (32: 6 windows)
    with the 7 test-time views and the gather lift, then without TTA and
    with the KNN lift, against pmf_tpu's SensatInference on the same
    weights: the `.label` files agree on >= 99.5 % of the points, the 2D
    and 3D mIoU within 0.002."""
    cfg = _config(sensat_root, tmp_path, compute_dtype="bfloat16")  # the CLI runs in float32
    model = tmodels.random_weights(tmodels.PMFNet(nclasses=14, base_channels=8), seed=2)
    weights = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), weights)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_cli_weights(mp, jinfer, model, "PMFNet")
        inf = jinfer.SensatInference(jload_options(cfg), "weights", scales=[32],
                                     save_preds=str(tmp_path / "jax_tta"))
        runs["tta"] = inf.run(max_frames=1)
        inf.use_tta, inf.use_knn = False, True          # the same jitted forward
        inf.save_preds = str(tmp_path / "jax_knn")
        inf.eval2d.reset()
        inf.eval3d.reset()
        runs["knn"] = inf.run(max_frames=1)
    for tag, flags in (("tta", []), ("knn", ["--knn", "--no-tta"])):
        d = str(tmp_path / f"torch_{tag}")
        got = infer_sensat.main([cfg, "--weights", weights, "--scales", "32", "--save-preds", d,
                                 "--max-frames", "1", "--device", "cpu", *flags])
        want = runs[tag]
        mine, theirs = _labels(d), _labels(str(tmp_path / f"jax_{tag}"))
        assert list(mine) == list(theirs) == ["block_0.label"]
        for n in mine:
            assert mine[n].shape == (3000,) and mine[n].max() <= 12
            assert (mine[n] == theirs[n]).mean() >= 0.995
        assert len(np.unique(mine["block_0.label"])) > 3
        for k in ("mIoU", "point_mIoU"):
            assert abs(got[k] - want[k]) <= 0.002 and np.isfinite(got[k]), k
        assert got["ms_per_forward"] > 0


def test_trainer_data_matches_jax(sensat_root, tmp_path, monkeypatch):  # noqa: F811
    """`Trainer.from_files` on SensatUrban: the rare-class alpha, class 0
    ignored, the class names shifted by one, the frame weights as the epoch
    and the val tiles, AMSGrad and Dice, as pmf_tpu's trainer sets them
    up."""
    cfg = _config(sensat_root, tmp_path)
    want = _jax_trainer_data(monkeypatch, cfg)
    trainer = Trainer.from_files(load_options(cfg), tmodels.PMFNet(nclasses=14, base_channels=8),
                                 torch.device("cpu"))
    np.testing.assert_array_equal(np.asarray(trainer.loss_cfg.alpha, np.float32), want.alpha)
    assert want.alpha[[0, 4, 12]].tolist() == [0.0, 2.0, 10.0]
    assert trainer.metrics.ignore == want.ignore_class == [0]
    assert trainer.class_names == want.mapped_cls_name and trainer.class_names[1] == "Ground"
    assert (trainer.loaders["Train"].n_samples, trainer.loaders["Validation"].n_samples) == \
        (want._train_len, want._val_len) == (2, 12)
    assert trainer.loss_cfg.use_dice and not trainer.point_lovasz
    assert isinstance(trainer.optimizer.optimizers["adamw"], ttrain.AMSGradW)
    assert (trainer.view_cfg[True].img_h, trainer.view_cfg[False].img_w) == \
        (want.sensat_cfg.img_h, want.sensat_eval_cfg.img_w)


def test_train_cli_debug_then_infer(sensat_root, tmp_path):  # noqa: F811
    """One debug `tools/train.py` run on SensatUrban (Dice, AMSGrad, the
    image-domain Lovász): finite losses, and its snapshot loads in
    `infer_sensat`."""
    cfg = _config(sensat_root, tmp_path, is_debug=True)
    best = train_cli.main([cfg, "--device", "cpu"])
    assert np.isfinite(best["IOU"])
    out = infer_sensat.main([cfg, "--weights", os.path.join(load_options(cfg).run_dir,
                                                            "checkpoint", "best_last_model.pth"),
                             "--scales", "32", "--no-tta", "--max-frames", "1",
                             "--device", "cpu"])
    assert np.isfinite(out["mIoU"]) and np.isfinite(out["point_mIoU"])
