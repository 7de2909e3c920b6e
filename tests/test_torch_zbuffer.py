"""The two z-buffer kernels' plain PyTorch versions against pmf_tpu's Pallas
kernels (interpret mode on the CPU), the per-scan scatter path against
pmf_tpu's. The CUDA kernels are held to their plain versions in
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu.ops import scatter as jscatter
from pmf_tpu.ops.pallas.tile_fill import rasterize_zbuffer_pallas
from pmf_tpu.ops.pallas.zbuffer import zbuffer_pallas
from pmf_tpu_torch.ops import rasterize as trast
from pmf_tpu_torch.ops import scatter as tscatter
from pmf_tpu_torch.ops import zbuffer as tzbuf
from tests.test_torch_cuda import pix_keys_with_ties, points_with_ties


def test_zbuffer_keys_plain_matches_pallas():
    B, N, H, W = 3, 700, 24, 40
    pix, key = pix_keys_with_ties(0, B, N, H, W)
    got = tzbuf.zbuffer_keys_plain(torch.from_numpy(pix), torch.from_numpy(key), H, W)
    assert got.shape == (B, H, W) and got.dtype == torch.int32
    for b in range(B):
        want = zbuffer_pallas(jnp.asarray(pix[b]), jnp.asarray(key[b]), H, W,
                              interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_zbuffer_keys_wrapper_takes_plain_on_cpu():
    pix, key = pix_keys_with_ties(1, 2, 300, 10, 12)
    before = tzbuf.zbuffer_keys.launches
    got = tzbuf.zbuffer_keys(torch.from_numpy(pix), torch.from_numpy(key), 10, 12)
    want = tzbuf.zbuffer_keys_plain(torch.from_numpy(pix), torch.from_numpy(key), 10, 12)
    assert torch.equal(got, want)
    assert tzbuf.zbuffer_keys.launches == before


@pytest.mark.parametrize("B,N,H,W", [(2, 3000, 48, 200), (1, 4096, 16, 128)])
def test_rasterize_plain_matches_pallas(B, N, H, W):
    rows, cols, depth, keep, vals = points_with_ties(2, B, N, H, W)
    canvas, mask = trast.rasterize_zbuffer_plain(
        *map(torch.from_numpy, (rows, cols, depth, keep, vals)), H, W)
    want_c, want_m = rasterize_zbuffer_pallas(
        *map(jnp.asarray, (rows, cols, depth, keep, vals)), H, W, interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want_c))
    before = trast.rasterize_zbuffer.launches
    c2, m2 = trast.rasterize_zbuffer(*map(torch.from_numpy, (rows, cols, depth, keep, vals)), H, W)
    assert torch.equal(c2, canvas) and torch.equal(m2, mask)
    assert trast.rasterize_zbuffer.launches == before


@pytest.mark.parametrize("N", [1000, 5000])
def test_scatter_path_matches_jax(N):
    """zbuffer_scatter_packed, fill_canvas and point_winner_flags, bit for
    bit, with the depth clip of the packed key at N's bit budget."""
    H, W = 30, 50
    rows, cols, depth, keep, vals = (a[0] for a in points_with_ties(3, 1, N, H, W))
    depth[:5] = 3e4                                 # past the clip at N = 5000
    t = {k: torch.from_numpy(v) for k, v in
         dict(rows=rows, cols=cols, depth=depth, keep=keep, vals=vals).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}

    winner, mask = tscatter.zbuffer_scatter_packed(t["rows"], t["cols"], t["depth"], t["keep"], H, W)
    jw, jm = jscatter.zbuffer_scatter_packed(j["rows"], j["cols"], j["depth"], j["keep"], H, W)
    np.testing.assert_array_equal(winner.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))

    canvas = tscatter.fill_canvas(t["vals"], winner, mask)
    jc = jscatter.fill_canvas(j["vals"], j["rows"], j["cols"], j["keep"], jw, jm)
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(jc))

    pix, won = tscatter.point_winner_flags(t["rows"], t["cols"], t["depth"], t["keep"], H, W)
    jpix, jwon = jscatter.point_winner_flags(j["rows"], j["cols"], j["depth"], j["keep"], H, W)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(jpix))
    np.testing.assert_array_equal(won.numpy(), np.asarray(jwon))
    assert won.sum() == mask.sum()


def test_packed_keys_reject_too_many_points():
    n = 1 << 22
    z = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError):
        tscatter.zbuffer_scatter_packed(z, z, z.float(), z.bool(), 4, 4)
