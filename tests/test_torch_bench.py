"""The port's bench (`pmf_tpu_torch/tools/bench.py`) on the CPU at a tiny
size: each phase's line with every field (time-based fields null, the
device named `cpu`), the seed's inputs, the eval FLOP count against
pmf_tpu's count of `bench.py: _eval_pipeline_fn`, each gate failing on a
corrupted view and on a corrupted prediction, and the exit without a card."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bench as jax_bench
from pmf_tpu import data as jdata
from pmf_tpu import models as jmodels
from pmf_tpu.models.torch_convert import convert_pmf_state_dict
from pmf_tpu.utils import flops as jflops
from pmf_tpu_torch.tools import bench
from tests.test_torch_train import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
P = bench.PHASES
# base 8 (the camera encoder stays ResNet34); the PMF scans at 64x160. The
# limits are the card's at full size, but two: the EPMF view is a centre crop
# of the kept points' box, which on these scans spans thousands of pixels, so
# at 64x128 it holds a few points at eval and the train crop often none (no
# occupancy floor); and at this size the bf16 step's weight gradients are
# chaotic under random weights (cosine 0.18-0.57 with the float32 ones, the
# camera encoder's down to 0.09), so they are held to a positive cosine only.
TINY = {
    "eval": dataclasses.replace(P["eval"], batch=2, points=2048, image=(64, 160),
                                view=(64, 160), base_channels=8),
    "train": dataclasses.replace(P["train"], batch=2, points=2048, image=(64, 160),
                                 view=(48, 96), base_channels=8, grad_cos_min=0.0),
    "epmf": dataclasses.replace(P["epmf"], batch=2, points=16384, view=(64, 128),
                                base_channels=8, occupied_min=0.0),
    "epmf_train": dataclasses.replace(P["epmf_train"], batch=2, points=16384, view=(64, 128),
                                      base_channels=8, occupied_min=0.0, grad_cos_min=0.0),
}
# fields that only the card gives: times, rates, memory, shares of device time
ON_CARD = ("value", "spread", "runs", "setup_s", "warmup_s", "syncs_per_call", "idle_share",
           "busy_ms", "wall_ms", "top_ops", "profiler", "card")


def run_main(capsys, *argv, phases=TINY) -> list[dict]:
    bench.main([*argv, "--device", "cpu"], phases=phases)
    return [json.loads(text) for text in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("name", list(TINY))
def test_phase_prints_every_field(name, capsys):
    phase = TINY[name]
    argv = ["--cell", phase.cell] if phase.cell else ["--phase", name]
    (line,) = run_main(capsys, *argv)
    assert list(line) == list(phase.fields())
    assert line["device"] == "cpu" and line["phase"] == name and line["cell"] == phase.cell
    card_only = [k for k in line if k in ON_CARD or k.endswith(("_ms", "_share", "_gib"))
                 or k.startswith("mfu_")]
    assert [k for k in card_only if k != "occupied_px_share" and line[k] is not None] == []
    assert line["flops"] > 0 and line[phase.flops_key] == line["flops"] / phase.batch / 1e9
    assert all(line[f"{k}_bytes"] > 0 and line[f"{k}_launches"] == 0 for k in bench.KERNELS)
    assert line["occupied_px_share"] == line["gates"]["occupied"] >= phase.occupied_min
    assert line["gates"]["view_differs_in"] == []
    if phase.train:
        assert line["gates"]["loss_rel"] <= phase.loss_rtol
        assert line["gates"]["grad_cos"] >= phase.grad_cos_min
    else:
        assert line["gates"]["agree"] >= phase.agree_min


def test_seed_draws_the_inputs():
    """The same seed gives the same scans, weights and generator; another
    seed gives others."""
    phase = TINY["train"]
    runs = [bench.Run(phase, seed, CPU) for seed in (3, 3, 4)]
    scans = [[t.numpy() for t in r.batch] for r in runs]
    weights = [torch.cat([p.detach().flatten() for p in r.model.parameters()]) for r in runs]
    draws = [torch.rand(4, generator=r.generator) for r in runs]
    assert all(np.array_equal(a, b) for a, b in zip(scans[0], scans[1]))
    assert torch.equal(weights[0], weights[1]) and torch.equal(draws[0], draws[1])
    assert not np.array_equal(scans[0][0], scans[2][0]) and not np.array_equal(scans[0][4],
                                                                                  scans[2][4])
    assert not torch.equal(weights[0], weights[2]) and not torch.equal(draws[0], draws[2])


def test_eval_flops_equal_bench_py():
    """The bench's FLOPs of one eval call (view, PMFNet, argmax) equal
    pmf_tpu's count of bench.py's own eval pipeline at the same shapes and
    weights (pmf_tpu's PMFNet without `use_packed`, the TPU layout that the
    port does not take)."""
    phase = TINY["eval"]
    run = bench.Run(phase, 0, CPU)
    got = bench.count_call_flops(run)
    params, stats = convert_pmf_state_dict(
        {k: v.numpy().copy() for k, v in run.model.state_dict().items()})
    (h, w), n = phase.image, phase.points
    cfg = jdata.PVConfig(canvas_h=h, canvas_w=w + 16, proj_h=h, proj_w=w, h_pad=7, w_pad=3,
                         n_points=n)
    jnet = jmodels.PMFNet(nclasses=20, base_channels=phase.base_channels, dtype=jnp.bfloat16)
    fn = jax_bench._eval_pipeline_fn(jax, jnp, jnet, cfg)
    want = jflops.count_flops(fn, {"params": params, "batch_stats": stats}, jnp.float32(0.0),
                              *(jnp.asarray(t.numpy()) for t in run.batch))
    assert got == want > 1e9


def _corrupt_view(build):
    def corrupted(*args, **kwargs):
        out = list(build(*args, **kwargs))
        out[1] = out[1].clone()
        out[1][0, 0, 0] = ~out[1][0, 0, 0]
        return tuple(out)
    return corrupted


def _corrupt_prediction(name, monkeypatch):
    """Eval: argmax_last names the next class; train: the step's model puts
    0.9 of each pixel's probability on the class after its most likely one
    (under random weights the probabilities are near uniform, so a mere
    permutation of the classes would leave the loss where it was)."""
    if name == "eval":
        argmax = bench.argmax_last
        monkeypatch.setattr(bench, "argmax_last", lambda x: (argmax(x) + 1) % x.shape[-1])
        return
    make_step = bench.make_pmf_train_step

    class Rolled(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, *args, **kwargs):
            def wrong(p):
                q = p.roll(1, dims=-1)
                return 0.9 * F.one_hot(q.argmax(-1), p.shape[-1]) + 0.1 * q
            return tuple(wrong(p) for p in self.net(*args, **kwargs))

    monkeypatch.setattr(bench, "make_pmf_train_step",
                        lambda model, *args, **kwargs: make_step(Rolled(model), *args, **kwargs))


@pytest.mark.parametrize("what", ["view", "prediction"])
@pytest.mark.parametrize("name", ["eval", "train"])
def test_gate_fails(name, what, monkeypatch, capsys):
    if what == "view":
        monkeypatch.setattr(bench, "build_batch", _corrupt_view(bench.build_batch))
    else:
        _corrupt_prediction(name, monkeypatch)
    with pytest.raises(SystemExit) as exit_:
        bench.main(["--phase", name, "--device", "cpu"], phases=TINY)
    message = str(exit_.value.code)
    assert message.startswith("bench: GATE FAILED") and capsys.readouterr().out == ""
    gates = json.loads(message.split(f"{name}: ", 1)[1])
    if what == "view":
        assert "mask" in gates["view_differs_in"]
    elif name == "eval":
        assert gates["agree"] < gates["agree_min"]
    else:
        assert gates["loss_rel"] > gates["loss_rtol"]


def test_no_card_exits(monkeypatch, capsys):
    """Without a card and without --device cpu the bench exits non-zero
    naming the reason, and prints no line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        bench.main([], phases=TINY)
    assert exit_.value.code not in (0, None) and "CUDA is not available" in str(exit_.value.code)
    assert capsys.readouterr().out == ""
