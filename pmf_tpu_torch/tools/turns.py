"""Compare a phase of `chip_smoke.py` between two checkouts on one card, in
turns (A, B, B, A, repeated), each run in a fresh process.

Usage (on the machine with the card, from the root of checkout B):
  python -m pmf_tpu_torch.tools.turns PARENT_DIR [--phase epmf_train] [--rounds 3]

Each run calls `chip_smoke.<phase>(cuda, smi)` in its checkout, after the
kernels' build and with TF32 off as `chip_smoke.py` runs it, and its output
lines that carry scans/s or ms/step are printed with the checkout's name,
then each checkout's median of them.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

_RUN = """
import torch, chip_smoke as c
from pmf_tpu_torch.ops import kernels
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
kernels.load()
getattr(c, {phase!r})(torch.device("cuda"), {smi!r})
"""


def run(checkout: str, phase: str, smi: str) -> list[str]:
    proc = subprocess.run([sys.executable, "-c", _RUN.format(phase=phase, smi=smi)],
                          cwd=checkout, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{phase} in {checkout} failed:\n{proc.stdout[-2000:]}"
                           f"{proc.stderr[-4000:]}")
    return [line for line in proc.stdout.splitlines()
            if ("scans/s" in line or "ms/step" in line) and not line.startswith("[trace]")]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent")
    parser.add_argument("--phase", default="epmf_train")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    trees = {"parent": os.path.abspath(args.parent), "change": os.getcwd()}
    numbers: dict = {name: [] for name in trees}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            for line in run(trees[name], args.phase, smi):
                print(f"{name}: {line}", flush=True)
                numbers[name].append(float(re.search(r"([0-9.]+) (?:scans/s|ms/step)", line)[1]))
    for name, values in numbers.items():
        print(f"{name}: median {statistics.median(values):.2f} of {values} ({args.phase}, {smi})")


if __name__ == "__main__":
    main()
