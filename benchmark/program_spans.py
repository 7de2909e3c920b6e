"""The port's own spans in a traced window (`trace.profile`'s dict): the
`user_annotation` events named `pmf.*` that `pmf_tpu_torch/utils/spans.py`
puts around its layers, and what ran on the device inside them.

- A span's occurrences: its events' intervals.
- The device time it launched: the union of the intervals of the device
  events (kernels, memsets, copies) whose launch starts inside one of its
  occurrences, on any thread (backward launches from autograd's thread).
  A device event's launch is the `cuda_runtime` event of its
  `args.correlation`; where the window holds none (a launch through the
  driver API), the host op of its `args["External id"]`.
- The device's idle time inside it: its occurrences' length less the
  union of every device interval clipped to them.
- Its host wall time: its occurrences' length.

Each is summed over the window; `per` divides by the occurrences of a
parent span (a step, a call, a scan). A span that did not occur reads
None, so the window of a program without spans reads nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "pmf."


def occurrences(window: dict, name: str) -> list[tuple[float, float]]:
    """(start, end) µs of each occurrence of the span `name`, by start."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in window["host"]
                  if e.get("cat") == "user_annotation" and e.get("name") == name)


def count(window: dict, name: str) -> int:
    return len(occurrences(window, name))


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint intervals by start."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def _holds(merged: list, ts: float) -> bool:
    """Whether the disjoint intervals `merged` (by start) hold `ts`."""
    i = bisect.bisect_right(merged, (ts, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= ts <= merged[i][1]


def launches(window: dict) -> list[tuple[float | None, int | None, dict]]:
    """(launch µs, launching thread, event) of each device event: its
    `cuda_runtime` event by `args.correlation`, else the host op of its
    `args["External id"]`; (None, None, event) where neither is in the
    window."""
    by_corr, by_ext = {}, {}
    for e in window["host"]:
        args = e.get("args", {})
        if e.get("cat") == "cuda_runtime" and "correlation" in args:
            by_corr[args["correlation"]] = (e["ts"], e.get("tid"))
        elif args.get("External id"):
            by_ext.setdefault(args["External id"], (e["ts"], e.get("tid")))
    out = []
    for d in window["device"]:
        args = d.get("args", {})
        ts, tid = by_corr.get(args.get("correlation")) or by_ext.get(args.get("External id")) \
            or (None, None)
        out.append((ts, tid, d))
    return out


def device_us(window: dict, name: str) -> float | None:
    """The device time launched inside the span `name` (the union of its
    device events' intervals), µs; None where it did not occur."""
    occ = occurrences(window, name)
    if not occ:
        return None
    merged = union(occ)
    return length((d["ts"], d["ts"] + d["dur"]) for ts, _, d in launches(window)
                  if ts is not None and _holds(merged, ts))


def idle_us(window: dict, name: str) -> float | None:
    """The device's idle time inside the span `name`'s occurrences, µs;
    None where it did not occur."""
    occ = occurrences(window, name)
    if not occ:
        return None
    busy = union((d["ts"], d["ts"] + d["dur"]) for d in window["device"])
    starts = [x for x, _ in busy]
    idle = 0.0
    for a, b in union(occ):
        idle += b - a
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(busy) and busy[i][0] < b:
            idle -= max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return idle


def host_us(window: dict, name: str) -> float | None:
    """The host wall time of the span `name`'s occurrences, µs; None where
    it did not occur."""
    occ = occurrences(window, name)
    return length(occ) if occ else None


def per(window: dict, us: float | None, parent: str) -> float | None:
    """`us` an occurrence of the span `parent`, in ms; None where either is
    missing."""
    n = count(window, parent)
    if us is None or not n:
        return None
    return us / n / 1e3


def innermost(window: dict) -> list[tuple[str | None, dict]]:
    """(the innermost `pmf.*` span holding its launch, event) of each
    device event: the latest-starting occurrence that holds the launch on
    the launching thread, else on any thread; None where no span holds it
    or the launch is not in the window."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
                   for e in window["host"]
                   if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX))
    by_tid = defaultdict(list)
    for s in spans:
        by_tid[s[3]].append(s)
    starts = {tid: [s[0] for s in v] for tid, v in by_tid.items()}
    all_starts = [s[0] for s in spans]

    def find(lst, st, ts):
        for i in range(bisect.bisect_right(st, ts) - 1, -1, -1):
            if lst[i][1] >= ts:
                return lst[i][2]
        return None

    out = []
    for ts, tid, d in launches(window):
        name = None
        if ts is not None:
            name = find(by_tid.get(tid, []), starts.get(tid, []), ts) or \
                find(spans, all_starts, ts)
        out.append((name, d))
    return out


def table(window: dict, parent: str, top: int = 5) -> dict:
    """Every `pmf.*` span of the window, an occurrence of `parent`: its
    occurrences, host ms, device ms launched inside it, idle ms inside it,
    and the `top` device operations launched innermost in it by their
    summed device ms; under None, the device events no span holds."""
    names = sorted({e["name"] for e in window["host"] if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX)})
    ops = defaultdict(lambda: defaultdict(float))
    for name, d in innermost(window):
        ops[name][d.get("name", "?")[:120]] += d["dur"]
    n = count(window, parent)
    scale = 1e3 * max(n, 1)
    out = {}
    for name in names + [None]:
        row = {"top": [[k, v / scale] for k, v in
                       sorted(ops[name].items(), key=lambda kv: -kv[1])[:top]]}
        if name is not None:
            row.update(count=count(window, name), host_ms=host_us(window, name) / scale,
                       device_ms=device_us(window, name) / scale,
                       idle_ms=idle_us(window, name) / scale)
        else:
            row["device_ms"] = sum(v for v in ops[None].values()) / scale
        out[str(name)] = row
    return out
