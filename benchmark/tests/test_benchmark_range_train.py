"""The cell `salsanext_kitti.train_b8` (SalsaNext's float32 train step on the
range view, `traffic/range_train_step.py`) on the CPU at a small size: it
is listed with exactly its readers; a sound run is `correct`, and an
unchanged state, a half batch and the bfloat16-operand control are not;
its traced run gives what its readers read; each new reader reads its
spans, and nothing where they are absent."""
import types

import pytest
import torch

from benchmark import control_range_train, core, run
from benchmark import program_spans as ps

SEED = 7 * 2**31 + 11
CELL = "salsanext_kitti.train_b8"
READERS = {"step_forward_ms.range_train", "step_loss_ms.range_train",
           "step_backward_ms.range_train", "view_ms.range_train", "k1_roofline.range_train",
           "idle_share.range_train", "mfu.range_train", "host_waits.range_train"}
SPAN_READERS = sorted(n for n in READERS if n.startswith(("step_", "view_", "k1_")))


def tiny() -> dict:
    """The cell at a 16x256 view, two scans of 2048 points (1800 valid) a
    batch; the configuration's widths as they are."""
    wl = core.workload(CELL)
    wl["config_data"]["view"].update(proj_h=16, proj_w=256, n_points=2048)
    wl["scans"].update(batch=2, points=2048, valid=1800)
    return wl


def _run(wl, tmp_path, monkeypatch) -> dict:
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    args = types.SimpleNamespace(seed=SEED, seconds=0.5, trace=0)
    result, _ = run.execute(args, wl, core.benchmark_json(), torch.device("cpu"), 1, 0.0)
    return result


def test_the_cell_is_listed_with_its_readers():
    bench = core.benchmark_json()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["chips"]) == ("salsanext_kitti", 1)
    e2e, layer = core.cell_metrics(CELL, bench)
    assert {m["name"] for m in e2e} == {"train_scans_per_s", "setup_s"}
    assert {m["name"] for m in layer} == READERS
    assert all(m["workloads"] == [CELL] for m in layer)
    cfg = core.config("salsanext_kitti")
    assert cfg["reduced"] == [] and (cfg["nclasses"], cfg["base_channels"]) == (20, 32)
    assert (cfg["compute_dtype"], cfg["tf32"]) == ("float32", False)
    wl = core.workload(CELL)
    assert (wl["scans"], wl["pool"]) == ({"batch": 8, "points": 131072, "valid": 122880}, 4)
    assert (cfg["view"]["proj_h"], cfg["view"]["proj_w"]) == (64, 2048)


def test_sound_run_is_correct(tmp_path, monkeypatch, one_thread):
    line = _run(tiny(), tmp_path, monkeypatch)
    assert line["correct"] and line["attempted"] > 0, line
    assert set(line["metrics"]) == {"setup_s", "train_scans_per_s"}
    assert line["checks"]["view_mismatch"]["value"] == 0


def test_unchanged_state_is_not_correct(tmp_path, monkeypatch, one_thread):
    from pmf_tpu_torch.train import optim

    monkeypatch.setattr(optim.ScheduledOptimizer, "step", lambda self: None)
    line = _run(tiny(), tmp_path, monkeypatch)
    assert not line["correct"] and line["checks"]["change_gap_median"]["value"] > 0.9


def test_half_batch_is_not_correct(tmp_path, monkeypatch, one_thread):
    from pmf_tpu_torch.train import steps

    plain = steps.salsanext_losses
    monkeypatch.setattr(steps, "salsanext_losses",
                        lambda pred, label, cfg: plain(pred[:1], label[:1], cfg))
    assert not _run(tiny(), tmp_path, monkeypatch)["correct"]


def test_bf16_control_is_not_correct(one_thread):
    """The reference with its convolutions' operands in bfloat16 in the
    program's place fails one of the cell's numbers at the small size,
    where the program passes every one."""
    wl = tiny()
    out = control_range_train.readings(wl, SEED, torch.device("cpu"), 0.3,
                                       parts=("program", "bf16"))
    assert all(c.ok for c in core.checks_from(out["program"], wl["limits"])), out
    assert not all(c.ok for c in core.checks_from(out["bf16"], wl["limits"])), out


def test_traced_run_feeds_every_reader(monkeypatch, one_thread):
    """The driver's traced run on the CPU (the card's sync calls stubbed):
    the step's spans, the view's and K1's are in its window, and each new
    reader reads a number from it but K1's roofline, which has no device
    time to divide by on the CPU."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a: None)
    cell = core.driver("range_train_step").Cell(tiny(), SEED, torch.device("cpu"))
    t = cell.trace(0.3)
    assert t["kind"] == "train" and t["flops_per_call"] > 0 and t["calls_per_s"] > 0
    assert t["work"]["zbuffer_keys"] == (2, 2048, 3600, 16, 256)
    got = {n: core.metric_reader(n).read(t) for n in READERS}
    assert got.pop("k1_roofline.range_train") is None
    assert all(v is not None for v in got.values()), got
    calls = t["window"]["calls"]
    assert [ps.count(t["window"], n) for n in ("pmf.step", "pmf.view", "pmf.k1")] == [calls] * 3
    assert got["view_ms.range_train"] > 0 and got["host_waits.range_train"] == 0


def _span(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}


def test_readers_read_their_spans_and_nothing_without_them():
    """Two steps of 100 µs: a view of 10 µs before each, holding K1's span
    (one kernel of 2 µs); the forward, the losses and the backward each
    launch one kernel (20, 5 and 40 µs), the backward's from another
    thread."""
    host, dev = [], []
    for k, t0 in enumerate((0, 200)):
        host += [_span("pmf.view", t0, 10), _span("pmf.k1", t0 + 2, 4),
                 _span("pmf.step", t0 + 20, 100), _span("pmf.step.forward", t0 + 21, 30),
                 _span("pmf.step.loss", t0 + 52, 10), _span("pmf.step.backward", t0 + 63, 40)]
        for j, (ts, dur, tid) in enumerate(((t0 + 3, 2, 1), (t0 + 22, 20, 1),
                                            (t0 + 53, 5, 1), (t0 + 64, 40, 2))):
            corr = 10 * k + j
            host.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                         "dur": 1, "tid": tid, "args": {"correlation": corr}})
            dev.append({"cat": "kernel", "name": "k", "ts": ts + 1, "dur": dur,
                        "args": {"correlation": corr}})
    work = (8, 131072, 983040, 64, 2048)
    t = {"window": {"device": sorted(dev, key=lambda e: e["ts"]), "host": host},
         "work": {"zbuffer_keys": work}}
    read = lambda name: core.metric_reader(name).read(t)
    assert read("step_forward_ms.range_train") == pytest.approx(0.020)
    assert read("step_loss_ms.range_train") == pytest.approx(0.005)
    assert read("step_backward_ms.range_train") == pytest.approx(0.040)
    assert read("view_ms.range_train") == pytest.approx(0.010)
    bound_us = max((8 * 131072 * 8 + 8 * 64 * 2048 * 4) / 3.35e12, 983040 / 67e12) * 1e6
    assert read("k1_roofline.range_train") == pytest.approx(100 * bound_us / 2.0)
    bare = {"window": {"device": dev, "host": [e for e in host
                                                if e["cat"] != "user_annotation"]},
            "work": {"zbuffer_keys": work}}
    assert all(core.metric_reader(n).read(bare) is None for n in SPAN_READERS)
    mfu = core.metric_reader("mfu.range_train").read
    assert mfu({"flops_per_call": 2.99e12, "calls_per_s": 3.0}) == pytest.approx(
        100 * 8.97e12 / 67e12)
    assert mfu({}) is None and core.metric_reader("host_waits.range_train").read({}) is None
    idle = core.metric_reader("idle_share.range_train").read
    assert idle({"busy_s": 0.8, "window_s": 1.0}) == pytest.approx(20.0) and idle({}) is None
