"""The cell `pmf_r50_nuscenes.eval_keyframe` (the nuScenes six-camera loop)
and the driver of EPMF's train step (`traffic/train_step_v2.py`, with its
workload `epmf_r34_kitti.train_b2`, which BENCHMARK.json leaves out while
its rate spreads too widely) end to end on the CPU at a tiny size: a sound
run is `correct`, a broken one and the control are not; the keyframe cell fails at once on a port whose loop counts no
keyframes; the new per-layer readers read the keyframe spans and nothing
where they are absent. The port computes in float32 here, so a sound run
reads near nought under the limits that the card's bfloat16 runs set."""
import types

import pytest
import torch

from benchmark import control_train_v2, core, run, span_table, span_table_keyframe
from benchmark import control
from benchmark.tests.conftest import tiny

SEED = 5 * 2**31 + 3
KEYFRAME = "pmf_r50_nuscenes.eval_keyframe"
TRAIN = "epmf_r34_kitti.train_b2"
KEYFRAME_READERS = ["camera_encoder_ms.keyframe", "fusion_ms.keyframe",
                    "lidar_stream_ms.keyframe", "merge_ms.keyframe"]


def tiny_keyframe(dtype: str = "float32") -> dict:
    """The keyframe cell at 64x160 with 2048 points (1500 returns), two
    keyframes in the pool; the configuration's widths as they are."""
    wl = core.workload(KEYFRAME)
    v = wl["config_data"]["view"]
    v.update(canvas_h=64, canvas_w=160, proj_h=64, proj_w=160, n_points=2048)
    wl["scans"].update(points=2048, returns=1500, image=[64, 160])
    wl.update(warmup=1, pool=2)
    wl["config_data"]["compute_dtype"] = dtype
    return wl


def tiny_train(dtype: str = "float32") -> dict:
    wl = tiny(TRAIN)
    wl["config_data"]["compute_dtype"] = dtype
    return wl


def _run(wl, tmp_path, monkeypatch) -> dict:
    """A whole run of the cell as `benchmark.run` makes it (the train
    driver's, which BENCHMARK.json does not list, with its own metric)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    args = types.SimpleNamespace(seed=SEED, seconds=0.5, trace=0)
    bench = core.benchmark_json()
    if wl["name"] == TRAIN:
        bench["end_to_end"] = [dict(m, workloads=[TRAIN]) if m["name"] == "train_scans_per_s"
                               else m for m in bench["end_to_end"]]
    result, _ = run.execute(args, wl, bench, torch.device("cpu"), 1, 0.0)
    return result


@pytest.mark.parametrize("make", [tiny_keyframe, tiny_train], ids=[KEYFRAME, TRAIN])
def test_sound_run_is_correct(make, tmp_path, monkeypatch, one_thread):
    line = _run(make(), tmp_path, monkeypatch)
    assert line["correct"] and line["attempted"] > 0, line
    assert set(line["metrics"]) == {"setup_s", "scan_latency_p95_ms" if make is tiny_keyframe
                                    else "train_scans_per_s"}


def test_train_cell_is_left_out_of_the_benchmark():
    bench = core.benchmark_json()
    assert TRAIN not in {w["name"] for w in bench["workloads"]}
    assert all(TRAIN not in m.get("workloads", []) for m in bench["end_to_end"] + bench["per_layer"])
    assert callable(core.metric_reader("mfu.train_b2").read)


def _altered_argmax(x):
    from pmf_tpu_torch.ops.reduce import argmax_last

    return (argmax_last(x) + 1) % x.shape[-1]


def test_altered_classes_are_not_correct(tmp_path, monkeypatch, one_thread):
    """Each item's classes altered where the loop lifts them: the merge no
    longer follows the item's probabilities."""
    monkeypatch.setattr("pmf_tpu_torch.tools.infer_nuscenes.argmax_last", _altered_argmax)
    line = _run(tiny_keyframe(), tmp_path, monkeypatch)
    assert not line["correct"] and line["checks"]["merge_mismatch"]["value"] > 0
    assert line["checks"]["view_mismatch"]["value"] == 0


def test_unchanged_state_is_not_correct(tmp_path, monkeypatch, one_thread):
    from pmf_tpu_torch.train import optim

    monkeypatch.setattr(optim.ScheduledOptimizer, "step", lambda self: None)
    line = _run(tiny_train(), tmp_path, monkeypatch)
    assert not line["correct"] and line["checks"]["change_gap_median"]["value"] > 0.9


def test_half_batch_is_not_correct(tmp_path, monkeypatch, one_thread):
    """The loss over half of each batch, σ's weighting kept."""
    from pmf_tpu_torch.train import steps

    plain = steps.pmf_losses

    def half(lidar, cam, label, cfg, points=None, mt_sigma=None):
        h = label.shape[0] // 2
        return plain(lidar[:h], cam[:h], label[:h], cfg, points, mt_sigma)

    monkeypatch.setattr(steps, "pmf_losses", half)
    assert not _run(tiny_train(), tmp_path, monkeypatch)["correct"]


def test_control_is_not_correct(tmp_path, monkeypatch, one_thread):
    """The float8 control in the program's place fails one of each cell's
    numbers at the tiny size."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    wl = tiny_keyframe("bfloat16")
    out = control.readings(wl, SEED, torch.device("cpu"), 0.5, parts=("program", "control"))
    assert out["program"]["merge_mismatch"] == 0
    assert not all(c.ok for c in core.checks_from(out["control"], wl["limits"])), out
    wl = tiny_train("bfloat16")
    out = control_train_v2.readings(wl, SEED, torch.device("cpu"), 0.5,
                                    parts=("program", "control"))
    assert not all(c.ok for c in core.checks_from(out["control"], wl["limits"])), out


def test_a_port_without_the_loop_counters_fails_at_once(monkeypatch, one_thread):
    """The cell reads the loop's `frames` counter: on a port that predates
    it the set-up stops before it makes the keyframes or the weights."""
    from pmf_tpu_torch.tools import infer_nuscenes

    plain = infer_nuscenes.NuscenesInference.__init__

    def older(self, *args, **kwargs):
        plain(self, *args, **kwargs)
        del self.items, self.frames, self.contested

    monkeypatch.setattr(infer_nuscenes.NuscenesInference, "__init__", older)
    made = []
    monkeypatch.setattr("benchmark.keyframes.pool", lambda *a: made.append(a))
    with pytest.raises(RuntimeError, match="counts no keyframes"):
        core.driver("keyframe_loop").Cell(tiny_keyframe(), SEED, torch.device("cpu"))
    assert made == []


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1, "args": {}}


def test_keyframe_readers():
    """Two keyframes of 100 µs, each with one item: its encoder and lidar
    stream (holding a fusion block) launch one kernel each; a merge of 4 µs."""
    host, dev = [], []
    for k, t0 in enumerate((0, 200)):
        host += [_span("pmf.keyframe", t0, 100), _span("pmf.model.camera_encoder", t0 + 10, 10),
                 _span("pmf.model.lidar_stream", t0 + 30, 30),
                 _span("pmf.model.lidar_stream.fusion", t0 + 40, 10),
                 _span("pmf.keyframe.merge", t0 + 80, 4)]
        for j, (ts, dur) in enumerate(((t0 + 11, 20), (t0 + 41, 30))):
            corr = 10 * k + j
            host.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                         "tid": 1, "args": {"correlation": corr}})
            dev.append({"cat": "kernel", "name": "k", "ts": ts + 1, "dur": dur,
                        "args": {"correlation": corr}})
    t = {"window": {"device": sorted(dev, key=lambda e: e["ts"]), "host": host}}
    read = lambda name: core.metric_reader(name).read(t)
    assert read("camera_encoder_ms.keyframe") == pytest.approx(0.020)
    assert read("lidar_stream_ms.keyframe") == pytest.approx(0.030)
    assert read("fusion_ms.keyframe") == pytest.approx(0.030)
    assert read("merge_ms.keyframe") == pytest.approx(0.004)
    bare = {"window": {"device": dev, "host": [e for e in host
                                                if e["cat"] != "user_annotation"]}}
    assert all(core.metric_reader(n).read(bare) is None for n in KEYFRAME_READERS)
    assert core.metric_reader("mfu.keyframe").read({"flops_per_call": 18e12,
                                                   "calls_per_s": 2.0}) == \
        pytest.approx(100 * 36e12 / 989e12)


def test_keyframe_table_takes_the_keyframe_as_parent(monkeypatch):
    """Without a card the table exits before it runs; its parent is set."""
    monkeypatch.setattr(span_table, "PARENTS", dict(span_table.PARENTS))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        span_table_keyframe.main(["--workload", KEYFRAME, "--seed", "1"])
    assert span_table.PARENTS["keyframe"] == "pmf.keyframe"


def test_every_span_reader_reads_nothing_without_spans():
    """A window of a program without spans (as a port that predates them):
    every `program_span` reader, the keyframe's four and the train
    driver's four among them, reads nothing."""
    bench = core.benchmark_json()
    readers = [m["name"] for m in bench["per_layer"] if m["source"] == "program_span"] + \
        [f"{m}.train_b2" for m in ("step_forward_ms", "step_backward_ms", "step_idle_ms",
                                   "view_ms")]
    assert len(readers) == 26 and set(KEYFRAME_READERS) <= set(readers)
    bare = {"window": {"device": [{"cat": "kernel", "name": "conv", "ts": 5, "dur": 3,
                                   "args": {"correlation": 1}}],
                       "host": [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2,
                                 "dur": 1, "tid": 1, "args": {"correlation": 1}}]},
            "work": {"rasterize": (8, 32768, 20000, 6, 256, 1024),
                     "zbuffer_keys": (8, 32768, 20000, 256, 1024)}}
    assert all(core.metric_reader(n).read(bare) is None for n in readers)
