"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor pmf_tpu, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pmf_tpu_torch.ops import rasterize as trast
from pmf_tpu_torch.ops import zbuffer as tzbuf

IMAX = 2**31 - 1


def points_with_ties(seed, B, N, H, W, F=6):
    """Random points with forced ties: points copied onto other points'
    pixel and depth (equal dq at different indices), points not kept, and
    rows/cols outside the image (clamped onto the border)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, H, (B, N)).astype(np.int32)
    cols = rng.integers(0, W, (B, N)).astype(np.int32)
    depth = rng.uniform(1, 80, (B, N)).astype(np.float32)
    src = rng.integers(0, N, (B, N // 10))
    dst = rng.integers(0, N, (B, N // 10))
    for b in range(B):
        rows[b, dst[b]] = rows[b, src[b]]
        cols[b, dst[b]] = cols[b, src[b]]
        depth[b, dst[b]] = depth[b, src[b]]
    depth[:, :50] = np.floor(depth[:, :50] * 64) / 64          # on a quantum edge
    rows[:, 50:60] = H + 3
    cols[:, 60:70] = -5
    keep = rng.random((B, N)) > 0.2
    vals = rng.normal(size=(B, N, F)).astype(np.float32)
    vals[..., 5] = rng.integers(0, 20, (B, N))
    return rows, cols, depth, keep, vals


def pix_keys_with_ties(seed, B, N, H, W):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, H * W + 1, (B, N)).astype(np.int32)   # incl. sentinel
    key = rng.integers(0, 1 << 30, (B, N)).astype(np.int32)
    key[:, : N // 10] = key[:, N // 10: 2 * (N // 10)]           # equal keys ...
    pix[:, : N // 10] = pix[:, N // 10: 2 * (N // 10)]           # ... on one pixel
    key[pix == H * W] = IMAX
    return pix, key


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_zbuffer_keys_kernel_matches_plain(cuda_device):
    B, N, H, W = 8, 32768, 384, 1232
    pix, key = (torch.from_numpy(a).to(cuda_device) for a in pix_keys_with_ties(4, B, N, H, W))
    before = tzbuf.zbuffer_keys.launches
    got = tzbuf.zbuffer_keys(pix, key, H, W)
    torch.cuda.synchronize()
    assert tzbuf.zbuffer_keys.launches == before + 1
    assert torch.equal(got, tzbuf.zbuffer_keys_plain(pix, key, H, W))


@pytest.mark.cuda
def test_rasterize_kernel_matches_plain(cuda_device):
    B, N, H, W = 8, 32768, 384, 1232
    args = [torch.from_numpy(a).to(cuda_device) for a in points_with_ties(5, B, N, H, W)]
    before = trast.rasterize_zbuffer.launches
    canvas, mask = trast.rasterize_zbuffer(*args, H, W)
    torch.cuda.synchronize()
    assert trast.rasterize_zbuffer.launches == before + 1
    want_c, want_m = trast.rasterize_zbuffer_plain(*args, H, W)
    assert torch.equal(mask, want_m) and torch.equal(canvas, want_c)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    rows, cols, depth, keep, vals = (torch.from_numpy(a).to(cuda_device)
                                     for a in points_with_ties(6, 2, 100, 8, 8))
    with pytest.raises(ValueError):
        trast.rasterize_zbuffer(rows.long(), cols, depth, keep, vals, 8, 8)
    with pytest.raises(ValueError):
        trast.rasterize_zbuffer(rows, cols, depth, keep, vals.transpose(0, 1), 8, 8)
    with pytest.raises(ValueError):
        tzbuf.zbuffer_keys(rows, cols.cpu(), 8, 8)
