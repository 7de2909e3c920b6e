"""The PyTorch port's building blocks against pmf_tpu on the CPU: layers,
resize, argmax, and the rule that the port imports nothing of JAX."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pmf_tpu.models import layers as jl
from pmf_tpu.ops import reduce as jreduce
from pmf_tpu.ops import resize as jresize
from pmf_tpu_torch.models import layers as tl
from pmf_tpu_torch.ops import reduce as treduce
from pmf_tpu_torch.ops import resize as tresize
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_leaky_relu_is_exact():
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    x[:8] = 0.0
    np.testing.assert_array_equal(tl.leaky_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.leaky_relu(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(2, 9, 14, 3), (1, 16, 16, 5)])
def test_pools(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(nhwc(tl.max_pool_3x3_s2(nchw(x))),
                                  np.asarray(jl.max_pool_3x3_s2(jnp.asarray(x))))
    # sum order of the 3x3 window differs: float32 rounding only
    np.testing.assert_allclose(nhwc(tl.avg_pool_3x3_s2(nchw(x))),
                               np.asarray(jl.avg_pool_3x3_s2(jnp.asarray(x))),
                               atol=1e-6)


class _JaxConvBN(nn.Module):
    features: int
    kernel: tuple
    stride: int
    padding: int
    dilation: int
    use_bias: bool
    act: str | None

    @nn.compact
    def __call__(self, x):
        return jl.conv_bn(x, features=self.features, kernel=self.kernel,
                          stride=self.stride, padding=self.padding,
                          dilation=self.dilation, use_bias=self.use_bias,
                          act=self.act, conv_name="conv", bn_name="bn",
                          train=False)


@pytest.mark.parametrize("kernel,stride,padding,dilation,use_bias,act", [
    ((3, 3), 1, 1, 1, False, "relu"),
    ((3, 3), 2, 1, 1, True, None),
    ((3, 3), 1, 2, 2, True, "leaky"),
    ((1, 1), 2, 0, 1, False, None),
    ((7, 7), 1, 3, 1, False, "relu"),
])
def test_conv_bn_fold_matches_jax(kernel, stride, padding, dilation, use_bias, act):
    """BN folded into the conv at eval, with random running statistics."""
    rng = np.random.default_rng(2)
    cin, cout = 5, 7
    x = rng.normal(size=(2, 16, 20, cin)).astype(np.float32)
    w = (rng.normal(size=(*kernel, cin, cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    gamma, beta = rng.normal(size=cout).astype(np.float32), rng.normal(size=cout).astype(np.float32)
    mean = rng.normal(size=cout).astype(np.float32)
    var = rng.uniform(0.5, 1.5, cout).astype(np.float32)

    conv_p = {"kernel": w, **({"bias": b} if use_bias else {})}
    variables = {"params": {"conv": {"Conv_0": conv_p},
                            "bn": {"BatchNorm_0": {"scale": gamma, "bias": beta}}},
                 "batch_stats": {"bn": {"BatchNorm_0": {"mean": mean, "var": var}}}}
    want = _JaxConvBN(cout, kernel, stride, padding, dilation, use_bias, act).apply(
        variables, jnp.asarray(x))

    conv = tl.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                     dilation=dilation, bias=use_bias)
    bn = tl.BatchNorm2d(cout)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        if use_bias:
            conv.bias.copy_(torch.from_numpy(b))
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
        acts = {"relu": torch.relu, "leaky": tl.leaky_relu, None: None}
        names = {"relu": "relu", "leaky": "leaky_relu", None: None}
        got = tl.conv_bn(nchw(x), conv, bn.eval(), names[act])
        unfolded = bn(conv(nchw(x)))
        if acts[act] is not None:
            unfolded = acts[act](unfolded)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    # the train-mode chain rounds the conv output before the affine, which
    # the folded form does not: 2e-5 on outputs near 5 for the 7x7 stem
    np.testing.assert_allclose(nhwc(unfolded), np.asarray(want), atol=1e-4)


def test_pixel_shuffle_is_exact():
    x = np.random.default_rng(3).normal(size=(2, 5, 6, 12)).astype(np.float32)
    np.testing.assert_array_equal(nhwc(tresize.pixel_shuffle(nchw(x), 2)),
                                  np.asarray(jresize.pixel_shuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (2, 4, 12, 8), (1, 1, 1, 2)])
def test_upsample_bilinear_matches_jax_image_resize(shape):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    got = nhwc(tresize.upsample_bilinear(nchw(x), 2))
    want = np.asarray(jresize.upsample_bilinear(jnp.asarray(x), 2))
    # edge rows and columns included: both clamp the half-pixel taps
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], atol=1e-6)


def test_argmax_last_ties_and_nan():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, (64, 7)).astype(np.float32)   # many ties
    x[3, 2] = np.nan
    x[9, :] = np.nan
    got = treduce.argmax_last(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jreduce.argmax_last(jnp.asarray(x))))
    assert got.dtype == np.int32
    assert got[3] == got[9] == 6          # a NaN row gives C-1
    ok = ~np.isnan(x).any(1)
    np.testing.assert_array_equal(got[ok], np.argmax(x[ok], axis=1))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_flax_or_pmf_tpu():
    files = sorted((REPO / "pmf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert {"augment.py", "range_pipeline.py", "infer_salsanext.py", "nuscenes.py", "infer_nuscenes.py",
            "merge_nuscenes_submission.py", "a2d2.py", "sensat_urban.py", "infer_a2d2.py",
            "infer_sensat.py", "dice.py", "native.py", "recorder.py", "logger.py", "mesh.py",
            "collectives.py", "dryrun.py"} <= {f.name for f in files}
    assert (REPO / "pmf_tpu_torch" / "parallel" / "__init__.py") in files
    banned = ("jax", "flax", "pmf_tpu", "torchvision")
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if any(m == b or m.startswith(b + ".") for b in banned)]
    assert not bad, bad
