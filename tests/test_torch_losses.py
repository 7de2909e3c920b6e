"""The port's losses against pmf_tpu's on the CPU: focal, KL, the
perception-aware KL and the three Lovász forms, values and gradients with
respect to the probabilities within 1e-5, on inputs made from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu import losses as jl
from pmf_tpu.ops import scatter as jscatter
from pmf_tpu_torch import losses as tl
from pmf_tpu_torch.ops import scatter as tscatter
from tests.torch_threads import one_torch_thread  # noqa: F401

C = 20
TOL = dict(rtol=1e-5, atol=1e-5)


def probs(seed, shape):
    """Softmax of random logits, float32."""
    z = np.random.default_rng(seed).normal(size=(*shape, C)) * 2
    p = np.exp(z - z.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def torch_value_and_grad(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward()
    return out.item(), [t.grad.numpy() for t in ts]


def jax_value_and_grad(fn, *arrays):
    v, g = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    return float(v), [np.asarray(x) for x in g]


def assert_same(got, want):
    (gv, gg), (wv, wg) = got, want
    np.testing.assert_allclose(gv, wv, **TOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_focal_matches_jax(masked):
    rng = np.random.default_rng(0)
    p = probs(1, (2, 6, 7))
    p[0, 0, 0] = 0.0                               # under the 1e-6 clamp
    p[0, 0, 0, 3] = 1.0
    target = rng.integers(0, C, (2, 6, 7))
    target[0, 0, 0] = 5
    alpha = rng.uniform(0, 1, C).astype(np.float32)
    mask = target > 0 if masked else None
    got = torch_value_and_grad(
        lambda x: tl.focal_softmax_loss(x, torch.from_numpy(target), torch.from_numpy(alpha),
                                        2.0, None if mask is None else torch.from_numpy(mask)), p)
    want = jax_value_and_grad(
        lambda x: jl.focal_softmax_loss(x, jnp.asarray(target), jnp.asarray(alpha), 2.0,
                                        None if mask is None else jnp.asarray(mask)), p)
    assert_same(got, want)


def test_kl_and_entropy_match_jax():
    log_pred = np.log(probs(2, (3, 5)))
    target = probs(3, (3, 5))
    target[0, 0, :4] = 0.0                          # 0 · log 0 = 0
    got = torch_value_and_grad(lambda a, b: tl.kl_div(a, b).sum(), log_pred, target)
    want = jax_value_and_grad(lambda a, b: jl.kl_div(a, b).sum(), log_pred, target)
    assert_same(got, want)
    p = probs(4, (3, 5))
    np.testing.assert_allclose(
        tl.normalized_entropy(torch.from_numpy(p), torch.log(torch.from_numpy(p))).numpy(),
        np.asarray(jl.normalized_entropy(jnp.asarray(p), jnp.log(jnp.asarray(p)))), **TOL)


def test_perception_aware_matches_jax():
    """Both KL terms and their gradients through the entropy gates, with
    confident pixels on either side so that both guides are nonzero."""
    pcd, img = probs(5, (2, 8, 9)), probs(6, (2, 8, 9))
    # sharpened: confident lidar pixels, then confident camera pixels; kept
    # above float32's subnormals, which XLA's CPU code flushes to 0
    pcd[0, :4] = np.maximum(probs(7, (4, 9)) ** 8, 1e-30)
    pcd[0, :4] /= pcd[0, :4].sum(-1, keepdims=True)
    img[1, :4] = np.maximum(probs(8, (4, 9)) ** 8, 1e-30)
    img[1, :4] /= img[1, :4].sum(-1, keepdims=True)

    def both(fn):
        return lambda a, b: (lambda o: o[0] + 2.0 * o[1])(fn(a, b, 0.7))

    got = torch_value_and_grad(both(tl.perception_aware_losses), pcd, img)
    want = jax_value_and_grad(both(jl.perception_aware_losses), pcd, img)
    assert_same(got, want)
    _, _, pg, ig = tl.perception_aware_losses(torch.from_numpy(pcd), torch.from_numpy(img))
    assert pg.sum() > 0 and ig.sum() > 0


@pytest.mark.parametrize("ignore,with_valid", [(0, False), (0, True), (None, False)])
def test_lovasz_image_matches_jax(ignore, with_valid):
    rng = np.random.default_rng(9)
    p = probs(10, (2, 12, 16))
    labels = rng.integers(0, 6, (2, 12, 16))        # some classes absent
    valid = rng.random((2, 12, 16)) > 0.3 if with_valid else None
    got = torch_value_and_grad(
        lambda x: tl.lovasz_softmax_loss(x, torch.from_numpy(labels), ignore,
                                         None if valid is None else torch.from_numpy(valid)), p)
    want = jax_value_and_grad(
        lambda x: jl.lovasz_softmax_loss(x, jnp.asarray(labels), ignore,
                                         None if valid is None else jnp.asarray(valid)), p)
    assert_same(got, want)


def rasterized_points(seed, B=2, N=600, H=12, W=20):
    """Points z-buffered onto a canvas by pmf_tpu's scatter path: the canvas
    labels, and per point its flat pixel, label and winner flag, with
    shared pixels, ties in depth, points not kept and labels 0 (ignored)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, H, (B, N)).astype(np.int32)
    cols = rng.integers(0, W, (B, N)).astype(np.int32)
    depth = rng.uniform(1, 50, (B, N)).astype(np.float32)
    depth[:, :50] = depth[:, 50:100]                 # equal depths ...
    rows[:, :50], cols[:, :50] = rows[:, 50:100], cols[:, 50:100]   # ... on one pixel
    keep = rng.random((B, N)) > 0.1
    label = rng.integers(0, 8, (B, N)).astype(np.int32)
    canvas, pix, won = [], [], []
    for b in range(B):
        w, m = jscatter.zbuffer_scatter_packed(rows[b], cols[b], depth[b], keep[b], H, W)
        canvas.append(np.asarray(jscatter.fill_canvas(
            jnp.asarray(label[b, :, None].astype(np.float32)), rows[b], cols[b], keep[b], w, m))[..., 0])
        p_, w_ = jscatter.point_winner_flags(rows[b], cols[b], depth[b], keep[b], H, W)
        pix.append(np.asarray(p_))
        won.append(np.asarray(w_))
    return np.stack(canvas).astype(np.int32), np.stack(pix), label, np.stack(won)


def test_rasterize_unique_matches_jax():
    labels_img, pix, _, won = rasterized_points(11)
    B, H, W = labels_img.shape
    vals = np.random.default_rng(12).normal(size=(*pix.shape, 5)).astype(np.float32)
    canvas, mask = tscatter.rasterize_unique(*map(torch.from_numpy, (pix, won, vals)), H, W)
    jc, jm = jax.vmap(lambda p, k, v: jscatter.rasterize_unique(p, k, v, H, W))(
        *map(jnp.asarray, (pix, won, vals)))
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert mask.sum() == won.sum() > 100


@pytest.mark.parametrize("ignore", [0, None])
def test_lovasz_points_match_jax_and_image_domain(ignore):
    """The point form against pmf_tpu's, and the port's own claim: on
    rasterized canvas labels it equals the image-domain loss."""
    labels_img, pix, label, won = rasterized_points(13)
    p = probs(14, labels_img.shape)
    ints = [torch.from_numpy(a) for a in (labels_img, pix, label, won)]
    jints = [jnp.asarray(a) for a in (labels_img, pix, label, won)]
    got = torch_value_and_grad(lambda x: tl.lovasz_softmax_loss_points(x, *ints, ignore=ignore), p)
    want = jax_value_and_grad(lambda x: jl.lovasz_softmax_loss_points(x, *jints, ignore=ignore), p)
    assert_same(got, want)
    if ignore is not None:       # every labelled pixel is one winner's
        image = torch_value_and_grad(
            lambda x: tl.lovasz_softmax_loss(x, ints[0], ignore=ignore), p)
        assert_same(got, image)


def test_lovasz_points_pair_matches_jax():
    labels_img, pix, label, won = rasterized_points(15)
    pa, pb = probs(16, labels_img.shape), probs(17, labels_img.shape)
    ints = [torch.from_numpy(a) for a in (labels_img, pix, label, won)]
    jints = [jnp.asarray(a) for a in (labels_img, pix, label, won)]
    got = torch_value_and_grad(
        lambda a, b: (lambda o: o[0] + 3.0 * o[1])(tl.lovasz_softmax_loss_points_pair(a, b, *ints)),
        pa, pb)
    want = jax_value_and_grad(
        lambda a, b: (lambda o: o[0] + 3.0 * o[1])(jl.lovasz_softmax_loss_points_pair(a, b, *jints)),
        pa, pb)
    assert_same(got, want)
    single = [tl.lovasz_softmax_loss_points(torch.from_numpy(x), *ints).item() for x in (pa, pb)]
    pair = [v.item() for v in tl.lovasz_softmax_loss_points_pair(
        torch.from_numpy(pa), torch.from_numpy(pb), *ints)]
    np.testing.assert_allclose(pair, single, rtol=1e-6)
