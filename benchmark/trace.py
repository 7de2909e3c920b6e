"""The traced run's readings: CUDA-event spans the benchmark puts around its
calls into each layer, the host's waits for the device (torch's sync debug
mode), and a torch.profiler window read from its Chrome trace (the device's
busy time as the union of its kernel, memset and memcpy intervals, each
kernel's device time by name, and the longest idle gaps by what the host
was doing meanwhile).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
import warnings
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


class Spans:
    """CUDA events recorded between the parts of a call: `mark(name)`
    closes the part that ran since the last mark; `done()` reads them."""

    def __init__(self):
        self.events, self.parts = [], defaultdict(list)

    def start(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((None, ev))

    def mark(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def done(self) -> dict:
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            if name is not None:
                self.parts[name].append(a.elapsed_time(b))
        self.events = []
        return {k: sum(v) / len(v) for k, v in self.parts.items()}


def host_waits(fn) -> int:
    """The operations in fn() that made the host wait for the device."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile(fn, calls: int) -> dict:
    """fn() `calls` times under torch.profiler: the device events and the
    host's ops of the window, and its wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e),
                 key=lambda e: e["ts"])
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")
            and "dur" in e]
    return {"device": dev, "host": host, "wall_s": wall, "calls": calls}


def busy_s(window: dict) -> float:
    """Seconds in which some operation ran on the device: the union of the
    device events' intervals."""
    total, end = 0.0, None
    for e in window["device"]:
        a, b = e["ts"], e["ts"] + e["dur"]
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def kernel_us(window: dict, names, memset_before: str | None = None) -> tuple[float, int]:
    """(device µs, launches) of the kernels whose trace names start with
    one of `names` (after the "void " that a template's name carries);
    with `memset_before`, a memset that the stream ran just before each
    launch of the kernel of that name counts too. Launches count
    `names[0]`'s."""
    dev = window["device"]
    total, launches = 0.0, 0
    for i, e in enumerate(dev):
        name = e.get("name", "").removeprefix("void ")
        if e.get("cat") != "kernel" or not name.startswith(tuple(names)):
            continue
        total += e["dur"]
        launches += name.startswith(names[0])
        if memset_before and name.startswith(memset_before):
            stream = e.get("args", {}).get("stream")
            for prev in reversed(dev[:i]):
                if prev.get("args", {}).get("stream") != stream:
                    continue
                if prev.get("cat") == "gpu_memset":
                    total += prev["dur"]
                break
    return total, launches


def top_ops(window: dict, n: int = 10) -> list:
    """The n device operations (by kernel name) that took most time, in
    seconds over the window."""
    by = defaultdict(float)
    for e in window["device"]:
        by[e.get("name", "?")[:120]] += e["dur"] / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(window: dict, n: int = 10) -> list:
    """The device's idle time, summed by the innermost host operation open
    at each gap's middle ("host" where none was), the n largest."""
    gaps, end = [], None
    for e in window["device"]:
        if end is not None and e["ts"] > end:
            gaps.append((end, e["ts"]))
        end = max(end or 0, e["ts"] + e["dur"])
    host = sorted(window["host"], key=lambda e: e["ts"])
    starts = [h["ts"] for h in host]
    by = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        name = "host"
        # the latest-starting op that is still open at mid (looking back a
        # bounded way: an op open across a gap starts shortly before it)
        for h in reversed(host[max(0, bisect.bisect_right(starts, mid) - 2000):
                               bisect.bisect_right(starts, mid)]):
            if h["ts"] + h["dur"] >= mid:
                name = h["name"][:120]
                break
        by[name] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
