"""The frozen reference against the port at a tiny size on the CPU (the
port's plain kernels stand in for K1 and K2 there), and the reference's
FLOP count at the cells' shapes."""
import numpy as np
import pytest
import torch

from benchmark import inputs, port
from benchmark.reference import flops, nets
from benchmark.reference import train as ref_train
from benchmark.reference import view as ref_view
from benchmark.tests.conftest import tiny

SEED = 2**32 + 11


def _batch(wl, seed=SEED):
    return inputs.to_device(inputs.scan_pool(seed, 1, wl["scans"], 20)[0], torch.device("cpu"))


@pytest.mark.parametrize("name", ["pmf_r34_kitti.eval_b8", "epmf_r34_kitti.eval_b8"])
def test_eval_view_and_net_equal_the_port(name, one_thread):
    from pmf_tpu_torch.data import build_batch, build_v2_batch

    wl = tiny(name)
    cfg = wl["config_data"]
    b = _batch(wl)
    rv, pv = port.reference_view(cfg), port.program_view_config(cfg)
    if cfg["net"] == "EPMFNet":
        got, want = build_v2_batch(*b, pv), ref_view.v2_batch(*b, rv)
    else:
        got, want = build_batch(*b, pv), ref_view.pv_batch(*b, rv)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[1].float().mean() > 0.01
    sd = port.make_weights(cfg, SEED, torch.device("cpu"))
    f32 = dict(cfg, compute_dtype="float32")
    prog = port.program_model(f32, sd, torch.device("cpu"), train=False)
    ref = port.reference_model(cfg, sd, torch.device("cpu"), train=False)
    with torch.no_grad():
        p, c = prog(want[0][..., :5], want[0][..., 5:8])
        rp, rc = ref(want[0][..., :5], want[0][..., 5:8])
    assert (p - rp).abs().max() < 1e-5 and (c - rc).abs().max() < 1e-5


def test_scan_view_equals_the_port(one_thread):
    from pmf_tpu_torch.data import build_eval_sample_with_uproj

    wl = tiny("pmf_r34_kitti.scan_b1")
    b = _batch(wl)
    s = [t[0] for t in b[:5]] + [int(b[5][0]), int(b[6][0])]
    got = build_eval_sample_with_uproj(*s, port.program_view_config(wl["config_data"]))
    want = ref_view.pv_scan(*s, port.reference_view(wl["config_data"]))
    for g, w in zip(got[:6], want):
        assert torch.equal(g, w)


def test_train_step_equals_the_port(one_thread):
    """The train view from one generator state, the losses, and one update
    of every parameter, the port's step in float32 against the reference."""
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.train import (HybridOptimizer, LossConfig, make_pmf_train_step,
                                     warmup_cosine_lr)

    wl = tiny("pmf_r34_kitti.train_b8")
    cfg, dev = wl["config_data"], torch.device("cpu")
    b = _batch(wl)
    sd = port.make_weights(cfg, SEED, dev)
    o, loss = cfg["optimizer"], cfg["loss"]
    prog = port.program_model(dict(cfg, compute_dtype="float32"), sd, dev, train=True)
    popt = HybridOptimizer(prog, warmup_cosine_lr(o["lr"], o["warmup_steps"], o["total_steps"]),
                           o["momentum"], o["weight_decay"])
    popt.steps = o["start_step"]
    step = make_pmf_train_step(prog, popt, LossConfig(
        nclasses=20, alpha=tuple(loss["alpha"]), gamma_focal=loss["gamma_focal"],
        lambda_=loss["lambda"], gamma=loss["gamma"], tau=loss["tau"]))
    g = torch.Generator().manual_seed(SEED)
    g_ref = torch.Generator().set_state(g.get_state())
    view = build_batch(*b, port.program_view_config(cfg), True, g, return_points=True)
    aux = step(view[0], view[2], g, view[3])

    ref = port.reference_model(cfg, sd, dev, train=True)
    ropt = ref_train.HybridOptimizer(
        ref, ref_train.warmup_cosine(o["lr"], o["warmup_steps"], o["total_steps"]),
        o["momentum"], o["weight_decay"], o["start_step"])
    rv = port.reference_view(cfg)
    want = ref_view.pv_batch(*b, rv, ref_view.train_draws(g_ref, 2, rv, dev), return_points=True)
    for x, y in zip([*view[:3], *view[3]], [*want[:3], *want[3]]):
        assert torch.equal(x, y)
    lidar, cam = ref(want[0][..., :5], want[0][..., 5:8], g_ref)
    total, terms = ref_train.pmf_losses(lidar, cam, want[2], want[3], loss)
    total.backward()
    ropt.step()
    assert float(aux["loss"]) == pytest.approx(float(total.detach()), rel=1e-5)
    assert float(aux["loss_lovasz"]) == pytest.approx(float(terms["lovasz"].detach()), rel=1e-5)
    assert torch.equal(g.get_state(), g_ref.get_state())
    gaps = [float((p - rp).norm() / ((rp - sd[k]).norm() + 1e-12))
            for (k, p), rp in zip(prog.named_parameters(), ref.parameters())
            if (rp - sd[k]).norm() > 0]
    assert np.median(gaps) < 1e-3


def test_flop_count_at_the_cells_shapes():
    """863.31 GFLOP a PMF eval scan and 11.578 TFLOP a PMF train step at
    batch 8 (the JAX package's counts, which the port's FLOP counter also gives)."""
    assert flops.count("PMFNet", 1, 384, 1232, 20, 32, train=False) / 1e9 == \
        pytest.approx(863.31, abs=0.01)
    assert flops.count("PMFNet", 8, 256, 1024, 20, 32, train=True) / 1e12 == \
        pytest.approx(11.578, abs=0.001)


def test_control_rounds_to_float8():
    x = torch.linspace(-3, 3, 1001)
    q = nets.to_fp8(x)
    assert 0 < (q - x).abs().max() < 3 / 8 and torch.unique(q).numel() < 256
