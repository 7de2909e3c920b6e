"""What every cell shares: finding a cell's files by name, the run's
environment and its guards, the scans and the weights made from the seed,
the whole-window statistics, and the comparisons that decide `correct`.

Nothing here imports the port: the traffic drivers (`benchmark/traffic/`)
are the only modules that call it.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent          # benchmark/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pmf_tpu")  # top-level module names a run may not hold
PORT = "pmf_tpu_torch"
# the port's own measuring code, which the benchmark copies and never runs
# (`pmf_tpu_torch.utils.flops` is loaded by `pmf_tpu_torch.utils` itself)
FORBIDDEN_PORT = ("pmf_tpu_torch.tools.bench", "pmf_tpu_torch.utils.timing")


# --- files found by name -------------------------------------------------

def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = CHECKOUT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(name: str, root: Path = ROOT) -> dict:
    """The cell `name`'s file, `workloads/<name>.json`, with its config's
    file, `configs/<config>.json`, under the key "config_data"."""
    wl = _json(root / "workloads" / f"{name}.json")
    wl["name"] = name
    wl["config_data"] = config(wl["config"], root)
    return wl


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def driver(kind: str, root: Path = ROOT):
    """The traffic driver `traffic/<kind>.py` (a module with a `Cell`)."""
    return _load(root / "traffic" / f"{kind}.py", f"benchmark_traffic_{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """The per-layer metric `name`'s reader, `metrics/<name>.py` (a module
    with `read(trace) -> float | None`)."""
    return _load(root / "metrics" / f"{name}.py", "benchmark_metric_" + name.replace(".", "_"))


def _load(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, bench: dict) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics of BENCHMARK.json that `cell` reports:
    those that list it under "workloads", or list none."""
    pick = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]
    return pick(bench["end_to_end"]), pick(bench["per_layer"])


# --- the run's environment and guards -------------------------------------

def set_cache_dirs(checkout: Path = CHECKOUT) -> None:
    """Every compile and kernel cache at a fixed directory inside the
    checkout's build/ (the port's nvcc library is written there too), so a
    second run of a cell finds what the first built."""
    build = checkout / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one the run may not hold,
    and the port's measuring modules (and any under them)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN
                   or any(m == f or m.startswith(f + ".") for f in FORBIDDEN_PORT)})


def reference_imports(root: Path = ROOT) -> list[tuple[str, str]]:
    """(file, module) for each import of the port, the JAX package or JAX
    in benchmark/reference/."""
    import ast

    bad = []
    for path in sorted((root / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path.name, n) for n in names if n.split(".")[0] in FORBIDDEN + (PORT,)]
    return bad


def process_start_time() -> float | None:
    """This process's start on the `time.time()` clock (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import time
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def sync(dev) -> None:
    """Wait for the work queued on `dev` (nothing to wait for on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --- whole-window statistics ----------------------------------------------

def rate(units: int, seconds: float) -> float:
    """Work per second over the whole window."""
    return units / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all `values`, linearly interpolated
    between the closest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def latencies(asks: list[float], closed: float) -> list[float]:
    """Each scan's latency, from the time the loop asked for it to the time
    it asked for the next one (`closed` for the last: when the loop asked
    after the window)."""
    return [b - a for a, b in zip(asks, asks[1:] + [closed])]


# --- the comparisons that decide `correct` --------------------------------

@dataclass
class Check:
    """One number compared: it passes when value <= limit (an exact
    comparison has the limit 0)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit and not math.isnan(self.value)


def checks_from(values: dict, limits: dict) -> list[Check]:
    """A Check for each compared number, with the cell's limit for it."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return [Check(k, float(v), float(limits[k])) for k, v in values.items()]


def prob_error(probs, ref) -> tuple[float, float]:
    """The two sums of `prob_err`: Σ|p − r| over every pixel and class, and
    Σ|r − 1/C|, the reference's distance from a flat prediction. Their
    ratio measures the error against the scale of what the net predicts,
    so it reads alike on seeds whose random weights give flat and peaked
    predictions."""
    import torch

    p, r = probs.double(), ref.double()
    return float((p - r).abs().sum()), float((r - 1.0 / r.shape[-1]).abs().sum())


class Reservoir:
    """A uniform sample of `k` of the calls of a window of unknown length,
    drawn from the seed (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        import random
        self.k, self.rng, self.n = k, random.Random(seed), 0

    def slot(self) -> int | None:
        """The slot that the next call's answer takes, or None."""
        i, self.n = self.n, self.n + 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def leaf_gaps(program: dict, reference: dict, keys) -> list[tuple[float, str]]:
    """Each leaf's gap between two norms: |‖p‖ − ‖r‖| over the larger of ‖r‖
    and the median leaf's ‖r‖; (gap, leaf), the largest first."""
    norms_r = {k: float(reference[k]) for k in keys}
    median = statistics.median(norms_r.values())
    return sorted(((abs(float(program[k]) - norms_r[k]) / max(norms_r[k], median, 1e-30), k)
                   for k in keys), reverse=True)
