"""The readings that the limits of the range train cell
(`traffic/range_train_step.py`, SalsaNext in float32) are set from, on the
card at the cell's own size (not run by the benchmark's runs):

    python -m benchmark.control_range_train --workload salsanext_kitti.train_b8
        --seeds 1 2 3 [--seconds 1] [--parts program tf32 bf16 half_batch reference_repeat]

For each seed, one JSON line: the compared numbers, each with its
readings that are not compared (`details`), of

- `program`: the cell's own run (set-up, a window of `--seconds`);
- `tf32`: the program's own steps with both TF32 flags on (the view
  before each step keeps them off, so it stays exact and the step alone
  computes below float32);
- `bf16`: the reference with every convolution's operands rounded to
  bfloat16 (`reference/salsanext.py: set_bf16`) in the program's place;
- `half_batch`: the fault that steps on the first half of each batch, the
  reference in the program's place;
- `reference_repeat`: a second run of the reference itself (what the
  card's unordered float32 sums alone move);

all against one run of the float32 reference. A state left unchanged reads
about 1 on the median change gaps by their definition.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import core

PARTS = ("program", "tf32", "bf16", "half_batch", "reference_repeat")
REFERENCE_PARTS = {"bf16": {"bf16": True}, "half_batch": {"half": True}, "reference_repeat": {}}


def tf32_cell(driver):
    """The driver's Cell with each train step run under both TF32 flags."""

    class Cell(driver.Cell):
        def call(self, i: int):
            with torch.no_grad():
                view = self.build(*self.pool[i % len(self.pool)], self.vcfg, True, self.g)
            flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                return (*view, ()), self.step(view[0], view[1], self.g)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    return Cell


def _program(cell_class, wl: dict, seed: int, dev, seconds: float):
    cell = cell_class(wl, seed, dev)
    cell.window(seconds)
    got = cell.program_readings()
    cell.release()
    return cell, got


def readings(wl: dict, seed: int, dev, seconds: float, parts=PARTS) -> dict:
    driver = core.driver(wl["traffic"])
    cell, got = _program(driver.Cell, wl, seed, dev, seconds)
    want = cell.reference_readings()
    runs = [("program", got, want)] + [(name, cell.reference_readings(**kw), want)
                                       for name, kw in REFERENCE_PARTS.items() if name in parts]
    if "tf32" in parts:
        # its window step is its own: the reference redoes it from its state
        tcell, tgot = _program(tf32_cell(driver), wl, seed, dev, seconds)
        runs.append(("tf32", tgot, tcell.reference_readings()))
        del tcell
    out = {"seed": seed, "cell": wl["name"]}
    for name, r, w in runs:
        out[name] = cell.compare(r, w)
        out[name + "_details"] = cell.details(r, w)
    del cell
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = p.parse_args(argv)
    core.set_cache_dirs()
    if not torch.cuda.is_available():
        print("control_range_train: needs a CUDA card", file=sys.stderr)
        raise SystemExit(1)
    wl = core.workload(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(readings(wl, seed, torch.device("cuda", 0), args.seconds, args.parts)),
              flush=True)


if __name__ == "__main__":
    main()
