"""The cell `epmf_r34_nuscenes.eval_keyframe` (EPMF's nuScenes six-camera
loop, `traffic/keyframe_loop_v2.py`) end to end on the CPU at a tiny size:
a sound run is `correct`; altered classes and the float8 control are not;
the cell stops at once on a port whose loop lacks the counters it reads;
its per-layer readers read the keyframe spans and the loop's counters, and
nothing where they are absent. The port computes in float32 here, so a
sound run reads near nought under the limits that the card's bfloat16 runs
set."""
import types

import pytest
import torch

from benchmark import control, core, run

SEED = 3 * 2**31 + 7
CELL = "epmf_r34_nuscenes.eval_keyframe"
SPAN_READERS = ["context_ms.epmf_keyframe", "camera_decoder_ms.epmf_keyframe",
                "model_host_ms.epmf_keyframe", "view_ms.epmf_keyframe"]
COUNTER_READERS = ["kept_points.epmf_keyframe", "empty_items.epmf_keyframe"]
SHARED_READERS = ["camera_encoder_ms.keyframe", "fusion_ms.keyframe", "lidar_stream_ms.keyframe",
                  "merge_ms.keyframe", "idle_share.keyframe", "mfu.keyframe", "host_waits.scan"]


def tiny(dtype: str = "float32") -> dict:
    """The cell at 64x160 (EPMF's multiples of 32) with 2048 points (1500
    returns), two keyframes in the pool; the configuration's widths as they
    are."""
    wl = core.workload(CELL)
    v = wl["config_data"]["view"]
    v.update(canvas_h=64, canvas_w=160, proj_h=64, proj_w=160, n_points=2048)
    wl["scans"].update(points=2048, returns=1500, image=[64, 160])
    wl.update(warmup=1, pool=2)
    wl["config_data"]["compute_dtype"] = dtype
    return wl


def _run(wl, tmp_path, monkeypatch) -> dict:
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    args = types.SimpleNamespace(seed=SEED, seconds=0.5, trace=0)
    result, _ = run.execute(args, wl, core.benchmark_json(), torch.device("cpu"), 1, 0.0)
    return result


def test_the_cell_is_listed_with_its_readers():
    bench = core.benchmark_json()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["chips"]) == ("epmf_r34_nuscenes", 1)
    e2e, layer = core.cell_metrics(CELL, bench)
    assert {m["name"] for m in e2e} == {"scan_latency_p95_ms", "setup_s"}
    assert {m["name"] for m in layer} == set(SPAN_READERS) | set(SHARED_READERS) | \
        set(COUNTER_READERS)
    cfg = core.config("epmf_r34_nuscenes")
    assert cfg["reduced"] == [] and (cfg["nclasses"], cfg["base_channels"]) == (17, 32)
    assert (cfg["view"]["proj_h"], cfg["view"]["proj_w"], cfg["view"]["n_points"]) == \
        (640, 1280, 65536)


def test_sound_run_is_correct(tmp_path, monkeypatch, one_thread):
    line = _run(tiny(), tmp_path, monkeypatch)
    assert line["correct"] and line["attempted"] > 0, line
    assert set(line["metrics"]) == {"setup_s", "scan_latency_p95_ms"}
    assert line["checks"]["prob_err"]["value"] < 1e-5


def _altered_argmax(x):
    from pmf_tpu_torch.ops.reduce import argmax_last

    return (argmax_last(x) + 1) % x.shape[-1]


def test_altered_classes_are_not_correct(tmp_path, monkeypatch, one_thread):
    """Each item's classes altered where the loop lifts them: the merge no
    longer follows the item's probabilities; the views stay exact."""
    monkeypatch.setattr("pmf_tpu_torch.tools.infer_nuscenes.argmax_last", _altered_argmax)
    line = _run(tiny(), tmp_path, monkeypatch)
    assert not line["correct"] and line["checks"]["merge_mismatch"]["value"] > 0
    assert line["checks"]["view_mismatch"]["value"] == 0


def test_control_is_not_correct(tmp_path, monkeypatch, one_thread):
    """The float8 control in the program's place fails the cell's limits at
    the tiny size, where the program in bfloat16 passes them."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    wl = tiny("bfloat16")
    out = control.readings(wl, SEED, torch.device("cpu"), 0.5, parts=("program", "control"))
    assert all(c.ok for c in core.checks_from(out["program"], wl["limits"])), out
    assert not all(c.ok for c in core.checks_from(out["control"], wl["limits"])), out


def test_a_port_without_the_counters_fails_at_once(monkeypatch, one_thread):
    """The cell reads the loop's `kept_points` and `empty_items`: on a port
    that predates them the set-up stops before it makes the keyframes or
    the weights."""
    from pmf_tpu_torch.tools import infer_nuscenes

    plain = infer_nuscenes.NuscenesInference.__init__

    def older(self, *args, **kwargs):
        plain(self, *args, **kwargs)
        del self.kept_points, self.empty_items

    monkeypatch.setattr(infer_nuscenes.NuscenesInference, "__init__", older)
    made = []
    monkeypatch.setattr("benchmark.keyframes.pool", lambda *a: made.append(a))
    with pytest.raises(RuntimeError, match="counts no kept points"):
        core.driver("keyframe_loop_v2").Cell(tiny(), SEED, torch.device("cpu"))
    assert made == []


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1, "args": {}}


def test_readers():
    """Two keyframes of 100 µs, each with one item: a view of 8 µs, the net
    of 40 µs holding the context blocks and the camera decoder, each of
    which launches one kernel."""
    host, dev = [], []
    for k, t0 in enumerate((0, 200)):
        host += [_span("pmf.keyframe", t0, 100), _span("pmf.view", t0 + 2, 8),
                 _span("pmf.model", t0 + 20, 40),
                 _span("pmf.model.lidar_stream.context", t0 + 22, 6),
                 _span("pmf.model.camera_decoder", t0 + 40, 10)]
        for j, (ts, dur) in enumerate(((t0 + 23, 25), (t0 + 41, 7))):
            corr = 10 * k + j
            host.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                         "tid": 1, "args": {"correlation": corr}})
            dev.append({"cat": "kernel", "name": "k", "ts": ts + 1, "dur": dur,
                        "args": {"correlation": corr}})
    t = {"window": {"device": sorted(dev, key=lambda e: e["ts"]), "host": host}}
    read = lambda name: core.metric_reader(name).read(t)
    assert read("context_ms.epmf_keyframe") == pytest.approx(0.025)
    assert read("camera_decoder_ms.epmf_keyframe") == pytest.approx(0.007)
    assert read("model_host_ms.epmf_keyframe") == pytest.approx(0.040)
    assert read("view_ms.epmf_keyframe") == pytest.approx(0.008)
    bare = {"window": {"device": dev, "host": [e for e in host
                                                if e["cat"] != "user_annotation"]}}
    assert all(core.metric_reader(n).read(bare) is None for n in SPAN_READERS)
    assert core.metric_reader("mfu.keyframe").read({"flops_per_call": 5.5e12,
                                                    "calls_per_s": 3.0}) == \
        pytest.approx(100 * 16.5e12 / 989e12)


def test_counter_readers():
    """The loop's counters a keyframe, as the cell's traced run gives
    them; nothing where the run gives none."""
    t = {"counters": {"kept_points": 6401.5, "empty_items": 4.0}}
    assert core.metric_reader("kept_points.epmf_keyframe").read(t) == 6401.5
    assert core.metric_reader("empty_items.epmf_keyframe").read(t) == 4.0
    assert all(core.metric_reader(n).read({}) is None for n in COUNTER_READERS)
