"""The harness without a card: its files found by name, BENCHMARK.json's
form, the whole-window statistics, the run's guards and the trace's
arithmetic."""
import json
import re
import shutil
import statistics

import pytest

from benchmark import core, roofline
from benchmark import trace as tr

BENCH = core.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_file_is_found_by_name():
    for c in BENCH["configs"]:
        assert core.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        wl = core.workload(w["name"])
        assert wl["config"] == w["config"] and hasattr(core.driver(wl["traffic"]), "Cell")
        e2e, layer = core.cell_metrics(w["name"], BENCH)
        assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2 and layer
    for m in BENCH["per_layer"]:
        assert callable(core.metric_reader(m["name"]).read)


def test_a_cell_added_as_files_is_found(tmp_path):
    """A further cell, configuration and metric are new files only."""
    root = tmp_path / "benchmark"
    shutil.copytree(core.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "pmf_r34_kitti.json").read_text())
    cfg["name"] = "pmf_r34_kitti_copy"
    (root / "configs" / "pmf_r34_kitti_copy.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "workloads" / "pmf_r34_kitti.eval_b8.json").read_text())
    wl.update(config="pmf_r34_kitti_copy", pool=2)
    (root / "workloads" / "pmf_r34_kitti_copy.eval_b4.json").write_text(json.dumps(wl))
    (root / "metrics" / "calls_per_s.eval.py").write_text(
        "def read(t):\n    return t.get('calls_per_s')\n")
    found = core.workload("pmf_r34_kitti_copy.eval_b4", root)
    assert found["config_data"]["name"] == "pmf_r34_kitti_copy" and found["pool"] == 2
    assert core.metric_reader("calls_per_s.eval", root).read({"calls_per_s": 3.0}) == 3.0
    assert hasattr(core.driver(found["traffic"], root), "Cell")
    assert all(p.read_bytes() == b for p, b in before.items())


def test_benchmark_json_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    seconds = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 180 + 1200 <= 43200


def test_whole_window_rate_and_tail_see_a_stall():
    steady = [0.02] * 400
    stalled = [0.02] * 370 + [0.5] * 30
    rate = lambda lat: core.rate(len(lat), sum(lat))
    assert rate(stalled) < 0.5 * rate(steady)
    asks = [sum(steady[:i]) for i in range(400)]
    assert core.latencies(asks, sum(steady)) == pytest.approx(steady)
    assert core.percentile(steady, 95) == pytest.approx(0.02)
    assert core.percentile(stalled, 95) > 0.4
    # the tail counts every scan: a median of chunks would hide the stall
    chunks = [sum(stalled[i:i + 40]) / 40 for i in range(0, 400, 40)]
    assert statistics.median(chunks) == pytest.approx(0.02)


def test_reservoir_is_uniform_and_seeded():
    picks = []
    for seed in range(400):
        r = core.Reservoir(2, seed)
        kept = {}
        for i in range(50):
            s = r.slot()
            if s is not None:
                kept[s] = i
        picks += kept.values()
    assert len(picks) == 800 and 10 < statistics.mean(picks) < 40
    a, b = core.Reservoir(2, 7), core.Reservoir(2, 7)
    assert [a.slot() for _ in range(30)] == [b.slot() for _ in range(30)]


def test_run_guard_holds_no_jax():
    assert core.forbidden_modules({"pmf_tpu_torch.ops": 1, "numpy": 1, "jaxtyping": 1,
                                   "pmf_tpu_torch.tools.benchmarks": 1,
                                   "pmf_tpu_torch.utils.flops": 1}) == []
    assert core.forbidden_modules({"jax.numpy": 1, "pmf_tpu.models": 1, "flax": 1}) == \
        ["flax", "jax.numpy", "pmf_tpu.models"]
    assert core.forbidden_modules({"pmf_tpu_torch.tools.bench": 1,
                                   "pmf_tpu_torch.utils.timing": 1}) == \
        ["pmf_tpu_torch.tools.bench", "pmf_tpu_torch.utils.timing"]


def test_reference_imports_nothing_of_the_port(tmp_path):
    assert core.reference_imports() == []
    root = tmp_path / "benchmark"
    shutil.copytree(core.ROOT / "reference", root / "reference")
    (root / "reference" / "bad.py").write_text("from pmf_tpu_torch.ops import argmax_last\n"
                                               "import jax.numpy\n")
    assert core.reference_imports(root) == [("bad.py", "pmf_tpu_torch.ops"),
                                            ("bad.py", "jax.numpy")]


def _window(events, host=()):
    return {"device": sorted(events, key=lambda e: e["ts"]), "host": list(host),
            "wall_s": 1e-3, "calls": 1}


def test_trace_busy_union_kernel_time_and_gaps():
    k = lambda name, ts, dur, cat="kernel": {"name": name, "ts": ts, "dur": dur, "cat": cat,
                                             "args": {"stream": 7}}
    w = _window([k("Memset (Device)", 0, 10, "gpu_memset"),
                 k("void ns::winners_kernel<unsigned int>(int)", 10, 30),
                 k("void ns::fill_kernel<unsigned int>(int)", 40, 20),
                 k("void other(int)", 50, 30),           # overlaps fill_kernel
                 k("void at::ns::fill_kernel<int>(int)", 200, 5),
                 k("ns::keys_kernel(int const*)", 300, 4)],
                host=[{"name": "aten::sort", "ts": 70, "dur": 150}])
    assert tr.busy_s(w) == pytest.approx(89e-6)
    us, launches = tr.kernel_us(w, ["ns::winners_kernel<", "ns::fill_kernel<"],
                                "ns::winners_kernel<")
    assert (us, launches) == (60.0, 1)
    assert tr.kernel_us(w, ["ns::keys_kernel("]) == (4.0, 1)
    assert tr.kernel_us(w, ["ns::zbuffer_keys_kernel("])[1] == 0
    assert tr.idle_gaps(w)[0] == ["aten::sort", pytest.approx(120e-6)]
    assert tr.top_ops(w, 1)[0][0] == "void ns::winners_kernel<unsigned int>(int)"


def test_roofline_share():
    work = roofline.rasterize_work(8, 32768, 20000, 6, 384, 1232)
    assert work[0] == 8 * 32768 * 37 + 8 * 384 * 1232 * 25
    bound = roofline.bound_s(*work)
    assert roofline.share(work, 2 * bound * 1e6, 1) == pytest.approx(50.0)
    assert roofline.share(work, 0.0, 0) is None
    reader = core.metric_reader("rasterize_roofline.eval")
    assert reader.read({"work": {}, "window": _window([])}) is None
