"""The fusion nets' last train options on the CPU: `remat` (the stages
recomputed in the backward pass, `models/layers.py: remat_stage`) against the
step without it in float64 with dropout on, against pmf_tpu's
`make_pmf_train_step(..., remat=True)` in float32, and under the row split
over gloo with the backward passes on threads of their own; and the
Trainer's `profile_dir` trace."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmf_tpu import models as jmodels
from pmf_tpu import train as jtrain
from pmf_tpu.models.torch_convert import convert_pmf_state_dict
from pmf_tpu_torch import data as tdata
from pmf_tpu_torch import models as tmodels
from pmf_tpu_torch import train as ttrain
from pmf_tpu_torch.losses import init_multi_task_params
from pmf_tpu_torch.parallel import dryrun
from pmf_tpu_torch.utils.flops import count_flops
from tests.test_torch_train import CFG, _aug, _named_grads, kitti_samples  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def grid():
    """data 1 x model 2 over gloo (`dryrun.remat_job`), started before the
    module's first test, so that it runs beside them."""
    with dryrun.Grid(2, 2, dryrun.remat_job, (0,), timeout_s=300.0) as g:
        yield g


@pytest.fixture(scope="module")
def pmf_batch(kitti_samples):
    """tests/test_torch_train.py's train view with the points' winner flags."""
    f, _, label, points = tdata.build_batch(*map(torch.from_numpy, kitti_samples),
                                            tdata.PVConfig(**CFG), train=True,
                                            aug_override=_aug(), return_points=True)
    return f, label, points


def _epmf_batch():
    """Random EPMF features at 2 x 32 x 64 (EPMFNet takes multiples of 32),
    a fifth of the pixels unlabelled."""
    rng = np.random.default_rng(31)
    shape = (2, 32, 64)
    label = np.where(rng.random(shape) < 0.2, 0, rng.integers(1, 20, shape))
    return torch.from_numpy(rng.normal(size=shape + (8,))), torch.from_numpy(label), None


def _step(net: str, batch, remat: bool, dtype=torch.float64, dropout=0.2):
    """One train step of `net` (base 8, random weights from a seed; EPMFNet
    with the multi-task σ) in `dtype`, dropout from a seeded generator: its
    loss terms, gradients, BN running statistics, the generator's state
    after it, and the step's FLOPs."""
    model = tmodels.random_weights(getattr(tmodels, net)(nclasses=20, base_channels=8,
                                                         dropout_rate=dropout), seed=21)
    model = model.to(dtype)
    model.dtype = dtype
    mtl = net == "EPMFNet"
    sigma = torch.nn.Parameter(init_multi_task_params(6).to(dtype)) if mtl else None
    opt = ttrain.HybridOptimizer(model, lambda s: 1e-3, 0.9, 1e-5,
                                 extra=[sigma] if mtl else [])
    cfg = ttrain.LossConfig(alpha=tuple(np.random.default_rng(22).uniform(0.2, 1, 20).tolist()),
                            use_mtloss=mtl)
    step = ttrain.make_pmf_train_step(model, opt, cfg, sigma, remat=remat)
    generator = torch.Generator().manual_seed(4)
    f, label, points = batch
    aux = {}
    flops = count_flops(lambda: aux.update(step(f.to(dtype), label, generator, points)))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    if mtl:
        grads["mt_sigma"] = sigma.grad.clone()
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    return aux, grads, stats, generator.get_state(), flops


@pytest.mark.parametrize("net", ["PMFNet", "EPMFNet"])
def test_remat_equals_the_step_without_it(pmf_batch, net):
    """Float64, dropout 0.2 (so each recomputed stage must draw its masks
    again from the generator's state before its forward): gradients within
    1e-12 of their norm, BN running statistics equal (moved once, not again
    by the recomputation), the generator where the step without remat
    leaves it, the losses equal; the recomputation shows in the FLOPs."""
    batch = pmf_batch if net == "PMFNet" else _epmf_batch()
    (a0, g0, s0, r0, n0), (a1, g1, s1, r1, n1) = (_step(net, batch, remat)
                                                  for remat in (False, True))
    for k, v in g0.items():
        assert float((g1[k] - v).norm()) <= 1e-12 * float(v.norm()), k
    assert all(torch.equal(s1[k], v) for k, v in s0.items())
    assert torch.equal(r1, r0)
    assert all(torch.equal(a1[k], v) for k, v in a0.items())
    assert n0 < n1 < 2 * n0


def test_remat_matches_pmf_tpu_remat(pmf_batch):
    """The port's remat step against pmf_tpu's `make_pmf_train_step(...,
    remat=True)` at dropout 0 in float32, held as
    tests/test_torch_train.py: test_pmfnet_train_step_gradients_match_jax
    holds the step without it: losses and BN running statistics 1e-5, each
    gradient within max(1e-4 of its norm, 10 x pmf_tpu's own move when the
    batch is reordered). pmf_tpu's step gives its gradients as its
    optimizer's state (a transformation that keeps them)."""
    f, label, points = pmf_batch
    alpha = tuple(np.random.default_rng(22).uniform(0.2, 1, 20).astype(np.float32).tolist())
    model = tmodels.random_weights(tmodels.PMFNet(nclasses=20, base_channels=8,
                                                  dropout_rate=0.0), seed=21)
    params, stats = convert_pmf_state_dict(
        {k: v.numpy().copy() for k, v in model.state_dict().items()})
    opt = ttrain.HybridOptimizer(model, lambda s: 1e-3, 0.9, 1e-5)
    got_aux = ttrain.make_pmf_train_step(model, opt, ttrain.LossConfig(alpha=alpha),
                                         remat=True)(f, label, None, points)

    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    state = jtrain.TrainState.create({"params": params, "batch_stats": stats}, keep)
    step = jtrain.make_pmf_train_step(jmodels.PMFNet(nclasses=20, base_channels=8,
                                                     dropout_rate=0.0), keep,
                                      jtrain.LossConfig(alpha=alpha), donate=False, remat=True)
    batch = [f.numpy(), label.numpy(), *(t.numpy() for t in points)]
    runs = [step(state, *(jnp.asarray(a[order]) for a in batch[:2]), jax.random.PRNGKey(0),
                 tuple(jnp.asarray(a[order]) for a in batch[2:]))
            for order in ([0, 1, 2], [2, 0, 1], [1, 2, 0])]
    (new_state, jaux), others = runs[0], [r[0].opt_state for r in runs[1:]]
    for k, v in jaux.items():
        if k not in ("conf", "conf_cam"):
            np.testing.assert_allclose(got_aux[k].item(), float(v), rtol=1e-5, err_msg=k)
    _, new_stats = convert_pmf_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    for a, b in zip(jax.tree_util.tree_leaves(new_stats),
                    jax.tree_util.tree_leaves(new_state.batch_stats)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    got = _named_grads(model)
    want = new_state.opt_state
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    paths = jax.tree_util.tree_flatten_with_path(got)[0]
    for (path, g), w, *rest in zip(paths, *map(jax.tree_util.tree_leaves, [want, *others])):
        w = np.asarray(w)
        err, norm = np.linalg.norm(g - w), np.linalg.norm(w)
        noise = max(np.linalg.norm(np.asarray(o) - w) for o in rest)
        assert err <= max(1e-4 * norm, 10 * noise) + 1e-7, (jax.tree_util.keystr(path), err,
                                                             noise, norm)


def test_remat_under_the_row_split(grid):
    """data 1 x model 2 over gloo, float64, the backward passes on threads
    of their own (as on the card, where a recomputation does not see the
    caller's row split unless it puts it in force itself): the PMF train
    step with remat equal to the split step without it, parameters within
    1e-10 of their norm, losses and BN statistics 1e-10, confusion equal."""
    ranks = grid.results()
    assert ranks[1] is None
    out = dryrun._compare(ranks[0][False], ranks[0][True])
    assert out["param_rel_err"] <= 1e-10 and out["loss_rel_err"] <= 1e-10
    assert out["stats_abs_err"] <= 1e-10 and out["conf_equal"]


def test_profile_dir_traces_train_iterations_2_to_4(tmp_path, monkeypatch):
    """Five train iterations: one trace file of rank 0 under `profile_dir`,
    holding train iterations 2, 3 and 4 of epoch 0 and their operations,
    none from validation; none under `is_debug` (one iteration an epoch);
    no profiler at all with the key unset."""
    trainer = dryrun.tiny_trainer(10, 5, config={"profile_dir": str(tmp_path / "trace")})
    trainer.run(0, "Train")
    trainer.run(0, "Validation")
    files = glob.glob(str(tmp_path / "trace" / "*"))
    assert len(files) == 1 and os.path.basename(files[0]).startswith("0.") \
        and files[0].endswith(".pt.trace.json")
    with open(files[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert sorted(n for n in names if "iteration" in n) == \
        [f"Train iteration {i}" for i in (2, 3, 4)]
    assert names.count("aten::convolution_backward") > 0

    dryrun.tiny_trainer(6, 5, config={"profile_dir": str(tmp_path / "debug")},
                        is_debug=True).run(0, "Train")
    assert not glob.glob(str(tmp_path / "debug" / "*"))

    def no_profiler(*args, **kwargs):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    assert np.isfinite(dryrun.tiny_trainer(6, 5).run(0, "Train")["Loss"])
