"""The share of the net's forwards (six a keyframe of the nuScenes loop, each at batch 1) that replayed CUDA graphs (the span `pmf.model.graphed` inside `pmf.model`, `pmf_tpu_torch/models/graphs.py`) over the traced window, %. None where either span is absent (a program without the graphs, or a window where no call replayed them)."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    calls, graphed = ps.count(w, "pmf.model"), ps.count(w, "pmf.model.graphed")
    return 100.0 * graphed / calls if calls and graphed else None
