"""The readings that the limits of a cell driven by `traffic/train_step_v2.py`
(EPMF's train step) are set from, on the card at the cell's own size (not
run by the benchmark's runs), as `control.py` reads them for PMF's train
cell:

    python -m benchmark.control_train_v2 --workload epmf_r34_kitti.train_b2 --seeds 1 2 3
        [--seconds 2] [--parts program control half_batch reference_repeat]
        [--compute-dtype float32]

For each seed, one JSON line: the compared numbers of the program, of the
control (the reference with float8 activations in the program's place),
of the fault that steps on half of each batch and of a second run of the
reference, each with its readings that are not compared (`details`).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import control, core


def readings(wl: dict, seed: int, dev, seconds: float, parts) -> dict:
    cell = core.driver(wl["traffic"]).Cell(wl, seed, dev)
    cell.window(seconds)
    out = {"seed": seed, "cell": wl["name"]}
    got = cell.program_readings()
    cell.release()
    want = cell.reference_readings()
    runs = [("program", got)] + [(name, cell.reference_readings(**kw))
                                 for name, kw in control.TRAIN_PARTS.items() if name in parts]
    for name, r in runs:
        out[name] = cell.compare(r, want)
        out[name + "_details"] = cell.details(r, want)
    del cell
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--parts", nargs="+", choices=control.PARTS,
                   default=["program", "control", "half_batch"])
    p.add_argument("--compute-dtype", default=None)
    args = p.parse_args(argv)
    core.set_cache_dirs()
    if not torch.cuda.is_available():
        print("control_train_v2: needs a CUDA card", file=sys.stderr)
        raise SystemExit(1)
    wl = core.workload(args.workload)
    if args.compute_dtype:
        wl["config_data"]["compute_dtype"] = args.compute_dtype
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(readings(wl, seed, torch.device("cuda", 0), args.seconds, args.parts)),
              flush=True)


if __name__ == "__main__":
    main()
