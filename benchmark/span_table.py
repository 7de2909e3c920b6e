"""Each of the port's spans in one cell's traced run: where the cell's time
goes, span by span.

    python3 -m benchmark.span_table --workload CELL --seed N [--seconds S] [--out FILE]

Sets the cell up as `benchmark.run` does, runs its traced run
(`Cell.trace`: a short timed window, then the torch.profiler window) and
prints one JSON object: the card, the profiled window's wall and busy
seconds, the parent span (a step, a call of the net or a scan) and its
count, the device events whose launch the window does not hold, the
runtime's synchronize calls by name, and for
every `pmf.*` span (`program_spans.table`) its occurrences, host ms, the
device ms it launched, the idle ms inside it and the device operations
launched innermost in it that took most time, each a parent. With
`--out` the object is also written to FILE. It checks nothing against the
reference; without a card it exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

from benchmark import core
from benchmark import program_spans as ps

PARENTS = {"train": "pmf.step", "eval": "pmf.model", "scan": "pmf.scan"}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    core.set_cache_dirs()
    wl = core.workload(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("span_table: needs a CUDA card", file=sys.stderr)
        raise SystemExit(1)
    if wl["config_data"].get("tf32") is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if "torch_threads" in wl:
        torch.set_num_threads(wl["torch_threads"])
    dev = torch.device("cuda", 0)
    data = core.driver(wl["traffic"]).Cell(wl, args.seed, dev).trace(args.seconds)
    window, parent = data["window"], PARENTS[data["kind"]]
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), "window_s": data["window_s"],
           "busy_s": data["busy_s"], "parent": parent, "parents": ps.count(window, parent),
           "device_events": len(window["device"]),
           "unlaunched": sum(ts is None for ts, _, _ in ps.launches(window)),
           "syncs": dict(Counter(e["name"] for e in window["host"]
                                 if e.get("cat") == "cuda_runtime" and "Synchronize" in e["name"])),
           "spans": ps.table(window, parent)}
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)


if __name__ == "__main__":
    main()
