"""The port's models against pmf_tpu's flax models on the CPU, in float32,
with random weights and random BatchNorm statistics (the port's
`random_weights`) carried across by the port's converter (flax → torch) and
pmf_tpu's (torch → flax)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmf_tpu import models as jmodels
from pmf_tpu.models.torch_convert import convert_generic_state_dict, convert_pmf_state_dict
from pmf_tpu_torch import models as tmodels
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W = 32, 96


def random_flax_tree(shapes, seed: int):
    """A tree shaped like `shapes` (from jax.eval_shape) of random numpy
    leaves; leaves named `var` are positive."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def save_flat_flax_npz(path: str, model: torch.nn.Module) -> str:
    """The model's weights as an .npz of the flat flax tree, one array per
    '/'-joined leaf path under 'params' and 'batch_stats'."""
    params, stats = convert_pmf_state_dict(_numpy_sd(model))
    flat = {}
    for top, tree in (("params", params), ("batch_stats", stats)):
        for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join([top] + [k.key for k in keys])] = leaf
    np.savez(path, **flat)
    return path


def _inputs(seed, c, n=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, h, w, c)).astype(np.float32)


def _check_probs(got: torch.Tensor, want):
    """f32 probabilities within 1e-4; argmax equal where the top-2 margin
    exceeds 1e-4, which holds for most pixels; more than one class wins."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    assert clear.mean() > 0.9
    assert len(np.unique(want.argmax(-1))) > 1


@pytest.fixture(scope="module")
def pmf_port():
    return tmodels.random_weights(tmodels.PMFNet(nclasses=20, base_channels=8), seed=0)


@pytest.fixture(scope="module")
def pmf_inputs():
    return _inputs(1, 5), np.random.default_rng(2).random((2, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("use_packed", [False, True])
def test_pmfnet_matches_flax(pmf_port, pmf_inputs, use_packed):
    params, stats = convert_pmf_state_dict(_numpy_sd(pmf_port))
    flax_model = jmodels.PMFNet(nclasses=20, base_channels=8, use_packed=use_packed)
    lidar_j, cam_j = jax.jit(lambda v, a, b: flax_model.apply(v, a, b, train=False))(
        {"params": params, "batch_stats": stats}, *pmf_inputs)
    with torch.no_grad():
        lidar_t, cam_t = pmf_port(*map(torch.from_numpy, pmf_inputs))
    _check_probs(lidar_t, lidar_j)
    _check_probs(cam_t, cam_j)


def test_pmf_convert_round_trip(pmf_port):
    """flax tree → port state_dict (models/convert.py) → flax tree
    (pmf_tpu's converter): every leaf comes back, bit for bit, and the tree
    has the flax model's own structure."""
    flax_model = jmodels.PMFNet(nclasses=20, base_channels=8)
    shapes = jax.eval_shape(
        lambda: flax_model.init({"params": jax.random.PRNGKey(0)},
                                jnp.zeros((1, H, W, 5)), jnp.zeros((1, H, W, 3))))
    params = random_flax_tree(shapes["params"], 3)
    stats = random_flax_tree(shapes["batch_stats"], 4)
    port = tmodels.PMFNet(nclasses=20, base_channels=8)
    port.load_state_dict(tmodels.state_dict_from_flax(port, params, stats))
    back_p, back_s = convert_pmf_state_dict(_numpy_sd(port))
    for a, b in ((params, back_p), (stats, back_s)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backbone", ["resnet34", "resnet50"])
def test_resnet_encoder_matches_flax(backbone):
    flax_model = jmodels.ResNetEncoder(backbone=backbone)
    x = _inputs(5, 3, h=32, w=48)
    shapes = jax.eval_shape(lambda: flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = random_flax_tree(shapes["params"], 6)
    stats = random_flax_tree(shapes["batch_stats"], 7)
    want = jax.jit(flax_model.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = tmodels.ResNetEncoder(backbone).eval()
    port.load_state_dict(tmodels.state_dict_from_flax(port, params, stats))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [g.shape[1] for g in got] == port.feature_channels
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        port(torch.zeros(1, 3, 24, 48))


def test_salsanext_matches_flax():
    port = tmodels.random_weights(tmodels.SalsaNext(nclasses=20, base_channels=8), seed=8)
    params, stats = convert_generic_state_dict(_numpy_sd(port))
    x = _inputs(9, 5)
    want = jax.jit(jmodels.SalsaNext(nclasses=20, base_channels=8).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        _check_probs(port(torch.from_numpy(x)), want)


def test_load_weights_pth_and_flat_flax_npz(pmf_port, tmp_path):
    """The CLI's two weight formats give the same model."""
    pth = str(tmp_path / "w.pth")
    torch.save(pmf_port.state_dict(), pth)
    npz = save_flat_flax_npz(str(tmp_path / "w.npz"), pmf_port)
    want = pmf_port.state_dict()
    for path in (pth, npz):
        got = tmodels.load_weights(tmodels.PMFNet(nclasses=20, base_channels=8), path)
        for k, v in want.items():
            assert torch.equal(got.state_dict()[k], v), (path, k)
