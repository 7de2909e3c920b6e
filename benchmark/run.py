"""Run one cell of the benchmark once on this machine's card.

    python -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

The cell is `benchmark/workloads/CELL.json`; its configuration, traffic
driver and per-layer metric readers are found by the names it and
BENCHMARK.json give. Set-up (inputs and weights from the seed, the port's
kernels built on first use, every shape of the cell warmed up) runs first;
then, with `--trace 0`, the window of S seconds gives the cell's
end-to-end metrics, and with `--trace 1` a short timed window, CUDA-event
spans, one call under torch's sync debug mode and a torch.profiler window
give its per-layer metrics. After the window the run holds no module of
JAX or the JAX package, frees the port's state and checks what the window
produced against the reference. The last line of stdout is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` a `breakdown`, and the compared numbers beside their limits
last); the compared numbers are also the last lines of stderr.

Without a CUDA card, or with fewer than the cell asks for, it exits 1 and
prints no result.
"""
from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import core  # noqa: E402


def fail(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(metrics: list[dict], data: dict) -> dict:
    """Each per-layer metric that its reader finds something to read."""
    out = {}
    for m in metrics:
        value = core.metric_reader(m["name"]).read(data)
        if value is None:
            continue
        if m["unit"] == "%" and value > 100.0:
            fail(f"{m['name']} reads {value} %: above 100 % is a fault of the count or "
                 "the timing")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> None:
    args = parse(argv)
    started = core.process_start_time() or _T_IMPORT
    core.set_cache_dirs()
    try:
        bench = core.benchmark_json()
        chips = next(c for c in bench["workloads"] if c["name"] == args.workload)["chips"]
        wl = core.workload(args.workload)
    except (OSError, StopIteration, KeyError) as e:
        fail(f"cannot find cell {args.workload!r}: {e!r}")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    result, checks = execute(args, wl, bench, torch.device("cuda", 0), chips, started)
    print(json.dumps(result), flush=True)
    for c in checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}): "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)


def execute(args, wl: dict, bench: dict, dev, chips: int, started: float):
    """Set up the cell, run its window (or its traced run) and check what
    it produced: (the result's line, the checks)."""
    import torch

    if wl["config_data"].get("tf32") is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if "torch_threads" in wl:   # a host-bound cell: few threads, a steadier host
        torch.set_num_threads(wl["torch_threads"])
    e2e, layer = core.cell_metrics(wl["name"], bench)
    run = core.driver(wl["traffic"]).Cell(wl, args.seed, dev)
    core.sync(dev)
    setup_s = time.time() - started

    if args.trace:
        data = run.trace(args.seconds)
        metrics = per_layer(layer, data)
        attempted = data["attempted"]
    else:
        out = run.window(args.seconds)
        attempted = out["attempted"]
        metrics = {}
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else out.get(m["name"])
            if value is None:
                fail(f"the cell's driver gives no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = dev.type == "cuda"
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips)) if on_card else 0

    held = core.forbidden_modules()
    if held:
        fail(f"the run holds modules it may not: {held}")

    checks = core.checks_from(run.check(), wl["limits"])
    correct = all(c.ok for c in checks)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else attempted, "metrics": metrics, "device": device}
    if args.trace:
        from benchmark import trace as tr
        device.update(busy_s=data["busy_s"], window_s=data["window_s"])
        result["breakdown"] = {"device_ops": tr.top_ops(data["window"]),
                               "idle_gaps": tr.idle_gaps(data["window"])}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks


if __name__ == "__main__":
    main()
