"""`correct` comes out false where it should: the control (the reference
with float8 convolution operands in the program's place) and runs whose
timed path is broken underneath, each against the cells' own limits.

On the CPU the cells run at a tiny size, and the port computes in float32
there, so that a sound run reads near nought and a broken one stands out
under the limits that the card's bfloat16 runs set. The card's test runs
the control at the cells' own sizes (`benchmark/control.py`).
"""
import types

import pytest
import torch

from benchmark import control, core, run
from benchmark.tests.conftest import tiny

CELLS = ["pmf_r34_kitti.train_b8", "pmf_r34_kitti.eval_b8", "epmf_r34_kitti.eval_b8",
         "pmf_r34_kitti.scan_b1"]
SEED = 3 * 2**31 + 1


def _float32(name):
    wl = tiny(name)
    wl["config_data"]["compute_dtype"] = "float32"
    return wl


def _run(wl, tmp_path, monkeypatch):
    """A whole run of the cell on the CPU (no look for a card): its line."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    args = types.SimpleNamespace(seed=SEED, seconds=0.5, trace=0)
    result, _ = run.execute(args, wl, core.benchmark_json(), torch.device("cpu"), 1, 0.0)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path, monkeypatch, one_thread):
    assert _run(_float32(name), tmp_path, monkeypatch)["correct"]


def _altered_argmax(x):
    from pmf_tpu_torch.ops.reduce import argmax_last

    return (argmax_last(x) + 1) % x.shape[-1]


FAULTS = {
    # an answer altered where it is produced
    "pmf_r34_kitti.eval_b8": [("pmf_tpu_torch.ops", "argmax_last", _altered_argmax)],
    "epmf_r34_kitti.eval_b8": [("pmf_tpu_torch.ops", "argmax_last", _altered_argmax)],
    "pmf_r34_kitti.scan_b1": [("pmf_tpu_torch.tools.infer_kitti", "argmax_last",
                               _altered_argmax)],
}


@pytest.mark.parametrize("name", list(FAULTS))
def test_altered_answer_is_not_correct(name, tmp_path, monkeypatch, one_thread):
    import importlib

    for module, attr, fn in FAULTS[name]:
        monkeypatch.setattr(importlib.import_module(module), attr, fn)
    assert not _run(_float32(name), tmp_path, monkeypatch)["correct"]


def test_unchanged_state_is_not_correct(tmp_path, monkeypatch, one_thread):
    """A step that returns its state unchanged."""
    from pmf_tpu_torch.train import optim

    monkeypatch.setattr(optim.ScheduledOptimizer, "step", lambda self: None)
    line = _run(_float32("pmf_r34_kitti.train_b8"), tmp_path, monkeypatch)
    assert not line["correct"]
    assert line["checks"]["change_gap_median"]["value"] > 0.9


def test_half_batch_is_not_correct(tmp_path, monkeypatch, one_thread):
    """Half of the batch left out, the mean taken over the rest."""
    from pmf_tpu_torch.train import steps

    monkeypatch.setattr(steps, "pmf_losses", _half_batch(steps.pmf_losses))
    assert not _run(_float32("pmf_r34_kitti.train_b8"), tmp_path, monkeypatch)["correct"]


def _after_warmup(wl, fn, plain):
    """`fn` in place of `plain` from the first step after the cell's set-up
    steps on: a fault that only the window's steps have."""
    calls = [0]

    def maybe(*args, **kwargs):
        calls[0] += 1
        return (fn if calls[0] > max(wl["warmup"], 3) else plain)(*args, **kwargs)

    return maybe


def _no_update(self):
    """A step that returns its state unchanged."""


def _half_batch(plain):
    """Half of the batch left out, the mean taken over the rest."""
    def half(lidar, cam, label, cfg, points=None, mt_sigma=None):
        h = label.shape[0] // 2
        pts = None if points is None else tuple(p[:h] for p in points)
        return plain(lidar[:h], cam[:h], label[:h], cfg, pts, mt_sigma)

    return half


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_fault_after_warmup_is_not_correct(fault, tmp_path, monkeypatch, one_thread):
    """A fault that starts with the window, after the set-up steps that the
    reference follows from the seed: the window step it redoes catches it."""
    from pmf_tpu_torch.train import optim, steps

    wl = _float32("pmf_r34_kitti.train_b8")
    if fault == "unchanged_state":
        monkeypatch.setattr(optim.ScheduledOptimizer, "step",
                            _after_warmup(wl, _no_update, optim.ScheduledOptimizer.step))
    else:
        monkeypatch.setattr(steps, "pmf_losses",
                            _after_warmup(wl, _half_batch(steps.pmf_losses), steps.pmf_losses))
    line = _run(wl, tmp_path, monkeypatch)
    assert not line["correct"]
    checks = line["checks"]
    assert checks["view_mismatch"]["value"] == 0 and checks["grad_gap_median"]["value"] < 1e-3
    assert max(checks["window_grad_gap_median"]["value"],
               checks["window_change_gap_median"]["value"]) > 0.1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path, monkeypatch, one_thread):
    """The control (the float32 reference with float8 activations in the
    program's place) fails one of the cell's numbers, at the tiny size."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    wl = tiny(name)
    out = control.readings(wl, SEED, torch.device("cpu"), 0.5)
    assert not all(c.ok for c in core.checks_from(out["control"], wl["limits"])), out


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name, card):
    """The control at the cell's own size, on the card, fails one of the
    cell's numbers."""
    wl = core.workload(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = control.readings(wl, SEED, card, 1.0)
    checks = core.checks_from(out["control"], wl["limits"])
    assert not all(c.ok for c in checks), out
