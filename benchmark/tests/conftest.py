"""Shared helpers of the benchmark's tests: the cells cut to a size the
CPU runs in seconds (the port's plain kernels stand in for K1 and K2 there)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import core  # noqa: E402


def tiny(name: str) -> dict:
    """The cell `name` at a tiny size: 64x160 views, 1024-2048 points, two
    scans a batch; the configurations' widths as they are."""
    wl = core.workload(name)
    v = wl["config_data"]["view"]
    v.update(canvas_h=64, canvas_w=176, proj_h=64, proj_w=160)
    if wl["config_data"]["net"] == "PMFNet":
        v.update(proj_ht=48, proj_wt=96, n_points=1024)
        wl["scans"].update(points=1024, image=[64, 160], batch=2)
    else:
        v.update(proj_ht=64, proj_wt=160, n_points=2048)
        # EPMF's view is the kept points' tight box: a shorter focal length
        # keeps the box near the tiny view, as 720 px keeps it at full size
        wl["scans"].update(points=2048, image=[64, 160], batch=2, fx=40.0)
    wl["warmup"] = min(wl["warmup"], 3)
    return wl


@pytest.fixture
def one_thread():
    """torch on few threads: the tests may run beside others."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
