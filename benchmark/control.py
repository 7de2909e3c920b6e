"""The readings that the cells' limits are set from, on the card at the
cells' own sizes (not run by the benchmark's runs):

    python -m benchmark.control --workload CELL --seeds 1 2 3 [--seconds 2]
        [--parts program control half_batch reference_repeat] [--compute-dtype float32]

For each seed: the cell's set-up and a short window at its own load, then
the compared numbers of the program (the lower readings), of the control
(the reference with its activations held in float8, one precision below
the configurations' bfloat16, put in the program's place)
and, for the train cell, of the fault that steps on half of each batch
(the reference put in the program's place) and of a second run of the
reference itself (what the card's unordered float32 sums alone move), with
the readings that are not compared (`details`); a state left unchanged
reads about 1 on the median change gaps by their definition. `--parts`
picks which of these a run reads (the program's always). One JSON line a
seed.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import core


PARTS = ("program", "control", "half_batch", "reference_repeat")
TRAIN_PARTS = {"control": {"fp8": True}, "half_batch": {"half": True}, "reference_repeat": {}}


def readings(wl: dict, seed: int, dev, seconds: float,
             parts=("program", "control", "half_batch")) -> dict:
    cell = core.driver(wl["traffic"]).Cell(wl, seed, dev)
    cell.window(seconds)
    out = {"seed": seed, "cell": wl["name"]}
    if wl["traffic"] == "train_step":
        got = cell.program_readings()
        cell.release()
        want = cell.reference_readings()
        runs = [("program", got)] + [(name, cell.reference_readings(**kw))
                                     for name, kw in TRAIN_PARTS.items() if name in parts]
        for name, r in runs:
            out[name] = cell.compare(r, want)
            out[name + "_details"] = cell.details(r, want)
    elif wl["traffic"] == "eval_batch":
        cell.release()
        out["program"] = cell.compare(cell.kept)
        if "control" in parts:
            out["control"] = cell.compare(cell.reference_outputs(fp8=True))
    else:
        answers = cell.program_answers()
        cell.release()
        out["program"] = cell.compare(answers)
        if "control" in parts:
            out["control"] = cell.compare(cell.reference_answers(fp8=True))
    del cell
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--parts", nargs="+", choices=PARTS, default=["program", "control",
                                                                  "half_batch"])
    p.add_argument("--compute-dtype", default=None,
                   help="run the program in this dtype instead of the configuration's "
                        "(a witness: float32 takes bfloat16's rounding out)")
    args = p.parse_args(argv)
    core.set_cache_dirs()
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
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
