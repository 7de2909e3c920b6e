"""The readers of the port's spans (`benchmark/program_spans.py`) on
synthetic Chrome-trace events: launches matched by correlation (or by the
host op's External id) to the innermost span, on any thread; device and
idle time clipped to a span; means a parent span; nothing where a span is
absent, as in a window of a program without spans."""
import pytest

from benchmark import core, roofline
from benchmark import program_spans as ps

BENCH = core.benchmark_json()


def span(name, ts, dur, tid=1, ext=None):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": {"External id": ext} if ext else {}}


def launch(corr, ts, tid=1):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def kernel(name, corr, ts, dur, cat="kernel", ext=None):
    args = {"correlation": corr, "stream": 7}
    if ext:
        args["External id"] = ext
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def window(device, host):
    return {"device": sorted(device, key=lambda e: e["ts"]), "host": list(host),
            "wall_s": 1e-3, "calls": 1}


def step_window():
    """Two steps (0-100, 200-300): each a forward (launching k1 and a memset
    at 10-11), a backward whose kernel is launched from another thread,
    and an optimizer; one kernel launched outside any span."""
    host, dev = [], []
    for s, base in enumerate((0, 200)):
        c = 10 * s
        host += [span("pmf.step", base, 100), span("pmf.step.forward", base + 5, 30),
                 span("pmf.k2", base + 8, 10), span("pmf.step.backward", base + 40, 40),
                 span("pmf.step.optimizer", base + 85, 10),
                 launch(c + 1, base + 9), launch(c + 2, base + 10), launch(c + 3, base + 20),
                 launch(c + 4, base + 41, tid=2), launch(c + 5, base + 86)]
        dev += [kernel("memset", c + 1, base + 12, 2, "gpu_memset"),
                kernel("winners_kernel", c + 2, base + 14, 6),
                kernel("conv", c + 3, base + 22, 8),
                kernel("conv_backward", c + 4, base + 45, 30),
                kernel("adam", c + 5, base + 90, 4)]
    host.append(launch(99, 150))
    dev.append(kernel("stray", 99, 152, 3))
    return window(dev, host)


def test_innermost_span_by_correlation_and_other_thread():
    got = {d["name"]: name for name, d in ps.innermost(step_window())}
    assert got == {"memset": "pmf.k2", "winners_kernel": "pmf.k2", "conv": "pmf.step.forward",
                   "conv_backward": "pmf.step.backward", "adam": "pmf.step.optimizer",
                   "stray": None}


def test_device_time_is_what_a_span_launched():
    w = step_window()
    # the forward holds k2: its memset and kernel count under both
    assert ps.device_us(w, "pmf.k2") == pytest.approx(2 * 8)
    assert ps.device_us(w, "pmf.step.forward") == pytest.approx(2 * 16)
    # launched from another thread inside the backward's interval
    assert ps.device_us(w, "pmf.step.backward") == pytest.approx(2 * 30)
    assert ps.device_us(w, "pmf.step") == pytest.approx(2 * 50)


def test_external_id_stands_in_for_a_missing_launch():
    host = [span("pmf.model", 0, 50), span("aten::conv", 5, 10, ext=7) | {"cat": "cpu_op"}]
    w = window([kernel("conv", 1234, 20, 6, ext=7)], host)
    assert ps.device_us(w, "pmf.model") == pytest.approx(6)
    assert ps.innermost(w)[0][0] == "pmf.model"


def test_idle_is_clipped_to_the_span():
    w = step_window()
    # step 1: busy 12-20, 22-30, 45-75, 90-94 inside 0-100 -> idle 50
    assert ps.idle_us(w, "pmf.step") == pytest.approx(2 * 50)
    # a kernel that runs past the span's end counts only up to it
    w2 = window([kernel("k", 1, 90, 20)], [span("pmf.scan", 0, 100), launch(1, 80)])
    assert ps.idle_us(w2, "pmf.scan") == pytest.approx(90)
    assert ps.host_us(w2, "pmf.scan") == pytest.approx(100)


def test_means_a_parent():
    w = step_window()
    assert ps.count(w, "pmf.step") == 2
    assert ps.per(w, ps.device_us(w, "pmf.step.forward"), "pmf.step") == pytest.approx(16e-3)
    assert ps.per(w, ps.host_us(w, "pmf.step.backward"), "pmf.step") == pytest.approx(40e-3)
    assert ps.per(w, ps.idle_us(w, "pmf.step"), "pmf.step") == pytest.approx(50e-3)
    t = {"window": w}
    assert core.metric_reader("step_backward_ms.train").read(t) == pytest.approx(30e-3)
    assert core.metric_reader("step_idle_ms.train").read(t) == pytest.approx(50e-3)
    table = ps.table(w, "pmf.step")
    assert table["pmf.k2"]["device_ms"] == pytest.approx(8e-3)
    assert table["pmf.step.forward"]["top"] == [["conv", pytest.approx(8e-3)]]
    assert table["None"]["device_ms"] == pytest.approx(1.5e-3)


def test_roofline_over_a_span():
    w = step_window()
    work = (8, 32768, 20000, 6, 256, 1024)
    t = {"window": w, "work": {"rasterize": work}}
    want = roofline.share(roofline.rasterize_work(*work), 16.0, 2)
    assert core.metric_reader("k2_roofline.train").read(t) == pytest.approx(want)


def test_nothing_where_the_span_is_absent():
    w = step_window()
    assert ps.device_us(w, "pmf.scan") is None and ps.idle_us(w, "pmf.scan") is None
    assert ps.host_us(w, "pmf.scan") is None and ps.per(w, 3.0, "pmf.scan") is None
    # a window of a program without spans: every span reader reads nothing
    bare = window([kernel("conv", 1, 5, 3)], [launch(1, 2)])
    t = {"window": bare, "work": {"rasterize": (8, 32768, 20000, 6, 256, 1024),
                                  "zbuffer_keys": (8, 32768, 20000, 256, 1024)}}
    readers = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]
    assert len(readers) == 18
    assert all(core.metric_reader(n).read(t) is None for n in readers)
