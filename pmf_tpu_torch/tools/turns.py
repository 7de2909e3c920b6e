"""Compare two checkouts on one card, in turns (A, B, B, A, repeated), each
run in a fresh process: the bench's cells, or a phase of `chip_smoke.py`.

Usage (on the machine with the card, from the root of checkout B):
  python -m pmf_tpu_torch.tools.turns PARENT_DIR --cell all [--rounds 3]
  python -m pmf_tpu_torch.tools.turns PARENT_DIR [--phase epmf_train] [--rounds 3]

With `--cell` (a cell of `tools/bench.py`, or `all`) each run is
`python -m pmf_tpu_torch.tools.bench --cell CELL --seed SEED` in its
checkout; each cell's `value` is printed with the checkout's name, then each
checkout's median, its runs' spread over the median (max - min, and between
the quartiles) and the change's median against the parent's. A checkout older than the bench can
be given the change's `pmf_tpu_torch/tools/bench.py` and
`pmf_tpu_torch/utils/timing.py`, so that both are measured by the same bench.

Otherwise each run calls `chip_smoke.<phase>(cuda, smi)` in its checkout,
after the kernels' build and with TF32 off as `chip_smoke.py` runs it, and
its output lines that carry scans/s or ms/step are printed with the
checkout's name, then each checkout's median of them.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

from ..utils.timing import card_name

_RUN = """
import torch, chip_smoke as c
from pmf_tpu_torch.ops import kernels
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
kernels.load()
getattr(c, {phase!r})(torch.device("cuda"), {smi!r})
"""


def _run(cmd: list[str], checkout: str, what: str) -> str:
    proc = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{what} in {checkout} failed:\n{proc.stdout[-2000:]}"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout


def run(checkout: str, phase: str, smi: str) -> list[str]:
    out = _run([sys.executable, "-c", _RUN.format(phase=phase, smi=smi)], checkout, phase)
    return [line for line in out.splitlines()
            if ("scans/s" in line or "ms/step" in line) and not line.startswith("[trace]")]


def run_bench(checkout: str, cell: str, seed: int) -> dict:
    """{cell: its line} of one bench run in `checkout`."""
    out = _run([sys.executable, "-m", "pmf_tpu_torch.tools.bench", "--cell", cell,
                "--seed", str(seed)], checkout, f"the bench ({cell})")
    lines = (json.loads(text) for text in out.splitlines() if text.startswith("{"))
    return {line["cell"]: line for line in lines}


def spreads(values: list[float]) -> str:
    """The runs' spread over their median: max - min, and between the
    quartiles."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return f"max - min {(max(values) - min(values)) / med:.5f}, quartiles {(q3 - q1) / med:.5f}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent")
    parser.add_argument("--cell", default=None, help="a cell of the bench, or all")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phase", default="epmf_train")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    smi = card_name()
    trees = {"parent": os.path.abspath(args.parent), "change": os.getcwd()}
    numbers: dict = {name: {} for name in trees}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            if args.cell:
                for cell, line in run_bench(trees[name], args.cell, args.seed).items():
                    print(f"{name}: {cell} {line['value']} {line['unit']} (spread "
                          f"{line['spread']} within the run)", flush=True)
                    numbers[name].setdefault(cell, []).append(line["value"])
                continue
            for line in run(trees[name], args.phase, smi):
                print(f"{name}: {line}", flush=True)
                value = float(re.search(r"([0-9.]+) (?:scans/s|ms/step)", line)[1])
                numbers[name].setdefault(args.phase, []).append(value)
    for what in numbers["change"]:
        medians = {}
        for name in trees:
            values = numbers[name][what]
            medians[name] = statistics.median(values)
            print(f"{name}: {what} median {medians[name]} of {values}, spread "
                  f"{spreads(values)} ({smi})")
        print(f"change against parent: {what} {medians['change'] / medians['parent'] - 1:+.5f}")


if __name__ == "__main__":
    main()
