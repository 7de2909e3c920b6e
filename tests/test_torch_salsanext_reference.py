"""SalsaNext on SemanticKITTI's range view in the port against the
benchmark's plain reference (`benchmark/reference/salsanext.py`,
`view_range.py`), at a small size on the CPU, each seeded: the net in
float32 (base 32, 20 classes) in eval and in train with dropout from one
generator; the train range view bit for bit (ties, points outside the
field of view, padding, the yaml's reversed yaw bounds); one
`make_salsanext_train_step` with `adamw` against the reference's step; the
spans of a profiled view and step; the float32 step off both epilogue
kernels' gates; and the benchmark's FLOP count of the step against the
port's.

They import neither JAX nor pmf_tpu.
"""
import ast
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core, inputs  # noqa: E402
from benchmark.reference import salsanext as ref  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.reference import view_range  # noqa: E402
from pmf_tpu_torch.data import build_range_batch, range_config  # noqa: E402
from pmf_tpu_torch.data.augment import draw_point_aug  # noqa: E402
from pmf_tpu_torch.models import SalsaNext, build_model, layers  # noqa: E402
from pmf_tpu_torch.ops import epilogue, epilogue_train  # noqa: E402
from pmf_tpu_torch.train import (LossConfig, adamw, make_salsanext_train_step,  # noqa: E402
                                 warmup_cosine_lr)
from pmf_tpu_torch.utils.flops import count_flops  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401

SEED = 2**31 + 23
C, B, H, W, N, VALID = 20, 2, 16, 256, 2048, 1800
CELL = core.workload("salsanext_kitti.train_b8")
CFG = CELL["config_data"]
STEP_PARTS = ["pmf.step.forward", "pmf.step.loss", "pmf.step.backward", "pmf.step.optimizer",
              "pmf.step.confusion"]
LIDAR = "pmf.model.lidar_stream"


def small_config() -> dict:
    """The cell's configuration at the tests' 16x256 view and 2048 points;
    its widths, augmentation, loss and schedule as they are."""
    cfg = json.loads(json.dumps(CFG))
    cfg["view"].update(proj_h=H, proj_w=W, n_points=N)
    return cfg


def driver():
    return core.driver("range_train_step")


def scans(seed: int = SEED, batch: int = B):
    """A batch of the cell's synthetic scans at the small size, as tensors."""
    group = {"batch": batch, "points": N, "valid": VALID}
    return [torch.from_numpy(a) for a in driver().scan_pool(seed, 1, group, C)[0]]


def weights(seed: int = SEED) -> dict:
    with torch.device("meta"):
        template = ref.SalsaNext(C, 32).state_dict()
    return inputs.weights(template, seed, torch.device("cpu"))


def nets(sd: dict):
    """(the port's SalsaNext as `build_model` makes it, the reference), both
    loaded with sd."""
    prog = build_model(driver().options(small_config()))
    prog.load_state_dict(sd)
    reference = ref.SalsaNext(C, 32)
    reference.load_state_dict(sd)
    return prog, reference


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_salsanext_matches_the_reference(mode):
    """The port's float32 SalsaNext (base 32, 20 classes, 5 channels)
    against the reference on the same seeded weights and input; in train
    mode the batch's BN statistics and dropout drawn from two generators of
    one seed, which both nets leave in the same state. Tolerance 1e-6 on
    probabilities: the same float32 ops on the CPU, where the two may only
    round BN's statistics apart (the port sums the batch, the reference
    takes a mean)."""
    prog, reference = nets(weights())
    x = torch.randn(B, H, W, 5, generator=torch.Generator().manual_seed(SEED))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    with torch.no_grad():
        if mode == "eval":
            p, r = prog.eval()(x), reference.eval()(x)
        else:
            p, r = prog.train()(x, g1), reference.train()(x, g2)
    assert p.shape == r.shape == (B, H, W, C)
    assert (p - r).abs().max() < 1e-6
    assert torch.equal(g1.get_state(), g2.get_state())
    # the classes depend on the input: the random weights are not flat
    assert p.argmax(-1).unique().numel() > 2


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_range_view_equals_the_reference_bit_for_bit(train):
    """Three batches of four scans through `build_range_batch` (K1's plain
    version on the CPU) and through the reference's view, with the draws
    of one seed: features, labels and mask equal. The scans hold ties (a
    tenth of the points repeat others), points beyond the 3°/−25° field of
    view (clamped into its edge rows) and padding; in train mode the
    draws include scans whose yaw is drawn, which the yaml's reversed
    bounds give as 5°."""
    cfg = small_config()
    vcfg = range_config(driver().options(cfg))
    view = view_range.RangeView.from_config(cfg)
    g1, g2 = torch.Generator().manual_seed(SEED), torch.Generator().manual_seed(SEED)
    yaws = []
    for k in range(3):
        points, labels, valid = scans(SEED + k, 4)
        if train:
            u = view_range.draws(g2, 4, None)
            yaws.append(draw_point_aug(torch.Generator().set_state(g1.get_state()), 4,
                                       vcfg.augment).yaw)
        with torch.no_grad():
            got = build_range_batch(points, labels, valid, vcfg, train, g1)
        want = view_range.range_batch(points, labels, valid, view, u if train else None)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        assert 0 < int(want[2].sum()) < 4 * VALID        # ties and misses took pixels
    if train:
        yaw = torch.cat(yaws)
        assert ((yaw == 5.0) | (yaw == 0.0)).all() and (yaw == 5.0).any() and (yaw == 0.0).any()
        assert torch.equal(g1.get_state(), g2.get_state())
    pitch = torch.rad2deg(torch.asin(points[0, :VALID, 2] / points[0, :VALID, :3].norm(dim=-1)))
    assert (pitch > 3.0).any() and (pitch < -25.0).any()


def _gradients(model) -> dict:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def test_train_step_matches_the_reference_step():
    """One `make_salsanext_train_step` with `adamw` at the cell's schedule
    step, from the train view, against `reference/salsanext.py: train_step`
    from the same view, weights and generator state: each leaf's gradient
    within 1e-4 of its largest element plus 1e-5 of the largest leaf's
    (float32 on the CPU; Lovász's weights come from a sort of errors that
    may round apart and so rank near-ties either way), and each leaf's
    change within 1e-6 (AdamW's first update is about the rate times the
    gradient's sign)."""
    cfg = small_config()
    o = cfg["optimizer"]
    schedule = warmup_cosine_lr(o["lr"], o["warmup_steps"], o["total_steps"])
    sd = weights()
    prog, reference = nets(sd)
    opt = adamw(prog, schedule)
    opt.steps = o["start_step"]
    loss = cfg["loss"]
    step = make_salsanext_train_step(prog, opt, LossConfig(
        nclasses=C, alpha=tuple(loss["alpha"]), gamma_focal=loss["gamma_focal"],
        lambda_=loss["lambda"], gamma=loss["gamma"], tau=loss["tau"]))
    vcfg = range_config(driver().options(cfg))
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        feature, label, _ = build_range_batch(*scans(), vcfg, True, g)
    state = g.get_state()
    aux = step(feature, label, g)
    ref_opt = ref.AdamW(reference, ref_train.warmup_cosine(o["lr"], o["warmup_steps"],
                                                           o["total_steps"]), o["start_step"])
    ref_loss, _ = ref.train_step(reference, ref_opt, feature, label,
                                 torch.Generator().set_state(state), loss)
    assert abs(float(aux["loss"]) - ref_loss) <= 1e-6 * abs(ref_loss)
    got, want = _gradients(prog), _gradients(reference)
    top = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        assert (got[k] - v).abs().max() <= 1e-4 * float(v.abs().max()) + 1e-5 * top, k
    theta_p, theta_r = dict(prog.named_parameters()), dict(reference.named_parameters())
    moved = 0
    for k, t in sd.items():
        if k in theta_r:
            dp, dr = theta_p[k].detach() - t, theta_r[k].detach() - t
            assert (dp - dr).abs().max() <= 1e-6, k
            moved += int(dr.abs().max() > 0)
    assert moved == len(theta_r)


def _spans(events):
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("pmf."))


def _inside(spans, parent):
    _, a, b = parent
    return [s[0] for s in sorted(spans, key=lambda s: s[1])
            if a <= s[1] and s[2] <= b and s != parent]


def test_profiled_view_and_step_hold_their_spans(tmp_path):
    """A traced train view and SalsaNext step: pmf.view holds pmf.k1; the
    step is pmf.step holding its five parts in order, .allreduce inside
    .backward, and pmf.model inside .forward; pmf.model holds
    pmf.model.lidar_stream and that holds one .context, four .encoder, one
    .head and one .decoder, as PMF's lidar stream names them."""
    cfg = small_config()
    prog = build_model(driver().options(cfg))
    step = make_salsanext_train_step(prog, adamw(prog, lambda s: 1e-3),
                                     LossConfig(alpha=tuple(cfg["loss"]["alpha"])))
    vcfg = range_config(driver().options(cfg))
    g = torch.Generator().manual_seed(SEED)

    def run():
        with torch.no_grad():
            feature, label, _ = build_range_batch(*scans(), vcfg, True, g)
        step(feature, label, g)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    got = _spans(json.loads(path.read_text())["traceEvents"])
    (view,) = [s for s in got if s[0] == "pmf.view"]
    (step_span,) = [s for s in got if s[0] == "pmf.step"]
    assert view[2] <= step_span[1] and _inside(got, view) == ["pmf.k1"]
    inner = _inside(got, step_span)
    assert [n for n in inner if n in STEP_PARTS] == STEP_PARTS
    backward = next(s for s in got if s[0] == "pmf.step.backward")
    assert _inside(got, backward) == ["pmf.step.allreduce"]
    forward = next(s for s in got if s[0] == "pmf.step.forward")
    (model,) = [s for s in got if s[0] == "pmf.model"]
    assert forward[1] <= model[1] and model[2] <= forward[2]
    (lidar,) = [s for s in got if s[0] == LIDAR]
    assert _inside(got, model) == [LIDAR] + _inside(got, lidar)
    parts = [n.removeprefix(LIDAR + ".") for n in _inside(got, lidar)]
    assert parts == ["context"] + ["encoder"] * 4 + ["head", "decoder"]


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    """The range view and the SalsaNext step enter no record_function with
    no profiler active."""
    cfg = small_config()
    prog = build_model(driver().options(cfg))
    step = make_salsanext_train_step(prog, adamw(prog, lambda s: 1e-3),
                                     LossConfig(alpha=tuple(cfg["loss"]["alpha"])))
    vcfg = range_config(driver().options(cfg))
    g = torch.Generator().manual_seed(SEED)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.no_grad():
        feature, label, _ = build_range_batch(*scans(), vcfg, True, g)
    step(feature, label, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_float32_step_takes_neither_epilogue_kernel(dtype, monkeypatch):
    """With the kernels' gates made blind to the device (as on the card), a
    SalsaNext train step calls neither the inference epilogue (A2) nor the
    train-mode one (A3) in float32, and their launch counters stay 0; the
    same step in bfloat16, the check that the gates are reached, sends
    every conv with a BN to A3 (its plain version on the CPU)."""
    calls = []
    plain_bn, plain_conv = epilogue_train.bn_epilogue, epilogue.conv_epilogue
    a2, a3 = plain_conv.launches, plain_bn.launches
    monkeypatch.setattr(epilogue, "epilogue_takes",
                        lambda t: t.dtype == torch.bfloat16 and t.dim() == 4 and
                        t.is_contiguous(memory_format=torch.channels_last))
    monkeypatch.setattr(epilogue_train, "bn_epilogue",
                        lambda *a, **k: calls.append("A3") or plain_bn(*a, **k))
    monkeypatch.setattr(epilogue, "conv_epilogue",
                        lambda *a, **k: calls.append("A2") or plain_conv(*a, **k))
    assert layers.epilogue is epilogue and layers.epilogue_train is epilogue_train
    model = SalsaNext(nclasses=C, base_channels=32, dtype=dtype)
    model.load_state_dict(weights())
    step = make_salsanext_train_step(model, adamw(model, lambda s: 1e-3),
                                     LossConfig(alpha=tuple(CFG["loss"]["alpha"])))
    x = torch.randn(B, H, W, 5, generator=torch.Generator().manual_seed(SEED))
    label = torch.randint(0, C, (B, H, W), generator=torch.Generator().manual_seed(1))
    step(x, label, torch.Generator().manual_seed(2))
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert calls == ([] if dtype == torch.float32 else ["A3"] * n_bn)
    assert (plain_conv.launches, plain_bn.launches) == (a2, a3)


def test_benchmark_flop_count_equals_the_ports():
    """The benchmark's FLOPs of a train step (the reference on `meta`) equal
    the port's counter on one `make_salsanext_train_step` at the same size
    (the losses, the update and the confusion matrix count nothing); at the
    cell's size, 8 x 64 x 2048, about 2.99 TFLOP a step."""
    model = build_model(driver().options(small_config()))
    step = make_salsanext_train_step(model, adamw(model, lambda s: 1e-3),
                                     LossConfig(alpha=tuple(CFG["loss"]["alpha"])))
    x = torch.randn(B, H, W, 5, generator=torch.Generator().manual_seed(SEED))
    label = torch.randint(0, C, (B, H, W), generator=torch.Generator().manual_seed(1))
    got = count_flops(step, x, label, torch.Generator().manual_seed(2))
    assert got == ref.count(B, H, W, C, 32) > 0
    assert 2.98e12 < ref.count(8, 64, 2048, C, 32) < 3.0e12


def test_reference_is_plain_and_float32():
    """The new reference files import nothing of the port, the JAX package
    or JAX; the reference's step runs with both TF32 flags off and leaves
    them as it found them."""
    root = Path(core.ROOT) / "reference"
    for name in ("salsanext.py", "view_range.py"):
        for node in ast.walk(ast.parse((root / name).read_text())):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 \
                else []
            assert not any(m.split(".")[0] in ("jax", "jaxlib", "pmf_tpu", "pmf_tpu_torch")
                           for m in mods), (name, mods)
    seen = []
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with ref.float32():
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        assert seen == [(False, False)]
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == \
            (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
