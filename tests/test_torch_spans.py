"""The port's spans (`pmf_tpu_torch/utils/spans.py`) at tiny sizes on the
CPU: with no profiler active none is entered; under torch.profiler the
train step, the eval CLI's per-scan loop and both fusion nets give their
span trees; `ms_per_scan` is the loop's wall time, the reader included.
One test needs the card: every kernel a train step launches falls in a
part of the step, and K2's kernels in pmf.k2.

They import neither JAX nor pmf_tpu; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pmf_tpu_torch.config import Options
from pmf_tpu_torch.data import build_batch
from pmf_tpu_torch.models import EPMFNet, random_weights
from pmf_tpu_torch.parallel import dryrun
from pmf_tpu_torch.tools.infer_kitti import Inference
from pmf_tpu_torch.train import HybridOptimizer, LossConfig, make_pmf_train_step
from pmf_tpu_torch.utils import spans
from tests.torch_threads import one_torch_thread  # noqa: F401

STEP_PARTS = ["pmf.step.forward", "pmf.step.loss", "pmf.step.backward", "pmf.step.optimizer",
              "pmf.step.confusion"]
SCAN_PARTS = ["pmf.scan.read", "pmf.scan.h2d", "pmf.view", "pmf.model", "pmf.scan.lift",
              "pmf.scan.readback", "pmf.scan.iou"]
STREAMS = ["pmf.model.camera_encoder", "pmf.model.lidar_stream", "pmf.model.camera_decoder"]
LIDAR_PARTS = {f"pmf.model.lidar_stream.{p}" for p in
               ("context", "encoder", "fusion", "head", "decoder")}
EPMF_DECODER_PARTS = {"pmf.model.camera_decoder.lidar_upsample", "pmf.model.camera_decoder.aspp"}
SCAN_KEYS = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")


def train_step(device):
    """(the tiny PMF train step, its train view's arguments, the generator)."""
    model = dryrun.tiny_model(torch.float32).to(device)
    optimizer = HybridOptimizer(model, lambda step: 0.01, 0.9, 1e-5)
    step = make_pmf_train_step(model, optimizer, LossConfig(alpha=(1.0,) * 20))
    batch = [torch.from_numpy(a).to(device) for a in dryrun.tiny_inputs(0, 2)]
    return step, batch, torch.Generator(device=device).manual_seed(0)


def run_step(step, batch, g):
    feature, _, label, points = build_batch(*batch, dryrun.tiny_cfg(), train=True, generator=g,
                                            return_points=True)
    return step(feature, label, g, points)


def inference(reader, n: int):
    """The eval CLI's loop over `n` tiny scans from `reader`, PMFNet base 8
    in float32 on the CPU."""
    cfg = dryrun.tiny_cfg()
    sensor = {k: getattr(cfg, k) for k in ("canvas_h", "canvas_w", "proj_h", "proj_w",
                                           "proj_ht", "proj_wt", "h_pad", "w_pad", "n_points")}
    opts = Options(config={"sensor": sensor}, dataset="SemanticKitti", nclasses=20,
                   net_type="PMFNet", compute_dtype="float32", base_channels=8)
    return Inference(opts, dryrun.tiny_model(torch.float32).eval(), reader, n,
                     torch.device("cpu"))


def tiny_reader():
    raw = dryrun.tiny_inputs(1, 3)
    return lambda i: {k: a[i] for k, a in zip(SCAN_KEYS, raw)}


def traced(fn, tmp_path, activities=(ProfilerActivity.CPU,)):
    """The Chrome trace events of fn() under torch.profiler."""
    with profile(activities=list(activities)) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def pmf_spans(events):
    """The port's spans: (name, start, end, thread), by start."""
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("pmf."))


def inside(spans_, parent):
    """The names of the spans inside `parent`'s interval on its thread, by
    start."""
    _, a, b, tid = parent
    return [s[0] for s in sorted(spans_, key=lambda s: s[1])
            if s[3] == tid and a <= s[1] and s[2] <= b and s != parent]


def only(names, keep):
    return [n for n in names if n in keep]


def test_no_record_function_without_a_profiler(monkeypatch):
    """One train step (with its view), one scan of the eval loop and one
    batched view enter no record_function with no profiler active; a span
    is then one shared null context."""
    step, batch, g = train_step(torch.device("cpu"))
    inf = inference(tiny_reader(), 1)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("pmf.a") is spans.span("pmf.b")
    run_step(step, batch, g)
    inf.run(1)
    with torch.no_grad():
        build_batch(*batch, dryrun.tiny_cfg())


def test_train_step_span_holds_its_five_parts_in_order(tmp_path):
    step, batch, g = train_step(torch.device("cpu"))
    got = pmf_spans(traced(lambda: run_step(step, batch, g), tmp_path))
    steps = [s for s in got if s[0] == "pmf.step"]
    assert len(steps) == 1
    assert only(inside(got, steps[0]), STEP_PARTS) == STEP_PARTS
    backward = next(s for s in got if s[0] == "pmf.step.backward")
    assert "pmf.step.allreduce" in inside(got, backward)
    # the view ran before the step, outside it, with both kernels' spans
    view = next(s for s in got if s[0] == "pmf.view")
    assert view[2] <= steps[0][1] and sorted(only(inside(got, view), {"pmf.k1", "pmf.k2"})) \
        == ["pmf.k1", "pmf.k2"]


def test_each_scan_span_holds_its_parts(tmp_path):
    inf = inference(tiny_reader(), 3)
    got = pmf_spans(traced(lambda: inf.run(3), tmp_path))
    scans = [s for s in got if s[0] == "pmf.scan"]
    assert len(scans) == 3
    for scan in scans:
        assert only(inside(got, scan), SCAN_PARTS) == SCAN_PARTS
        assert "pmf.k1" in inside(got, scan) and "pmf.scan.save" not in inside(got, scan)


@pytest.mark.parametrize("net", ["PMFNet", "EPMFNet"])
def test_model_span_holds_the_three_streams(net, tmp_path):
    if net == "PMFNet":
        model, (h, w) = dryrun.tiny_model(torch.float32), (dryrun.H, dryrun.W)
    else:
        model, (h, w) = random_weights(EPMFNet(nclasses=20, base_channels=8), seed=3), (32, 64)
    gen = torch.Generator().manual_seed(0)
    pcd, img = torch.randn(1, h, w, 5, generator=gen), torch.rand(1, h, w, 3, generator=gen)
    with torch.no_grad():
        got = pmf_spans(traced(lambda: model.eval()(pcd, img), tmp_path))
    models = [s for s in got if s[0] == "pmf.model"]
    assert len(models) == 1
    assert only(inside(got, models[0]), STREAMS) == STREAMS
    lidar = next(s for s in got if s[0] == "pmf.model.lidar_stream")
    assert set(inside(got, lidar)) == LIDAR_PARTS
    decoder = next(s for s in got if s[0] == "pmf.model.camera_decoder")
    assert set(inside(got, decoder)) == (EPMF_DECODER_PARTS if net == "EPMFNet" else set())


def test_ms_per_scan_counts_the_reader():
    """A reader that takes 5 ms a scan: `ms_per_scan` reads at least 5, and
    no more than the loop's wall time a scan."""
    read = tiny_reader()

    def slow_reader(i):
        time.sleep(0.005)
        return read(i)

    inf = inference(slow_reader, 2)
    t0 = time.perf_counter()
    out = inf.run(2)
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    assert 5.0 <= out["ms_per_scan"] <= wall_ms


@pytest.mark.cuda
def test_train_step_kernels_fall_in_its_parts(tmp_path):
    """On the card: every kernel launched inside pmf.step is launched inside
    one of its parts, and pmf.k2 launches K2's two kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    dev = torch.device("cuda")
    step, batch, g = train_step(dev)
    run_step(step, batch, g)                     # builds the kernels, warms cuDNN up
    torch.cuda.synchronize()
    events = traced(lambda: (run_step(step, batch, g), torch.cuda.synchronize()), tmp_path,
                    (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    got = pmf_spans(events)
    # each kernel's launch: its runtime or driver call, by correlation
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [(e["name"], launch.get(e["args"].get("correlation"))) for e in events
               if e.get("cat") == "kernel"]
    assert kernels and all(ts is not None for _, ts in kernels)
    holds = lambda s, ts: s[1] <= ts <= s[2]
    (step_span,) = [s for s in got if s[0] == "pmf.step"]
    parts = [s for s in got if s[0] in STEP_PARTS]
    in_step = [(n, ts) for n, ts in kernels if holds(step_span, ts)]
    assert in_step and all(any(holds(p, ts) for p in parts) for _, ts in in_step), \
        [n for n, ts in in_step if not any(holds(p, ts) for p in parts)][:5]
    (k2,) = [s for s in got if s[0] == "pmf.k2"]
    k2_kernels = {n for n, ts in kernels if holds(k2, ts)}
    assert any("winners_kernel" in n for n in k2_kernels)
    assert any("fill_kernel" in n for n in k2_kernels)
