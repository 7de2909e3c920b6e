"""Forward-output parity against the reference torch models.

Instantiates the ACTUAL reference implementations
(/root/reference/pc_processor/models/{salsanext,pmf_net,epmf_net}.py)
with random weights, converts the full state_dict through
pmf_tpu.models.torch_convert, and asserts flax forward agreement in f32
eval mode. This is the strongest accuracy-parity check available without
the datasets: it validates every block of every model family and the
converter at once (the 63.9/76.9 mIoU targets rest on it).

torchvision is stubbed (tests/_torchvision_stub.py) — the container has
torch but not torchvision.
"""
import importlib.util
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread  # noqa: E402, F401

REF = "/root/reference/pc_processor/models"


@pytest.fixture(scope="module")
def ref_models():
    import os
    spec = importlib.util.spec_from_file_location(
        "_torchvision_stub",
        os.path.join(os.path.dirname(__file__), "_torchvision_stub.py"))
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)

    tv = types.ModuleType("torchvision")
    tv_models = types.ModuleType("torchvision.models")
    tv_resnet = types.ModuleType("torchvision.models.resnet")
    for n in ("resnet34", "resnet50", "resnet101", "resnet152"):
        setattr(tv_resnet, n, getattr(stub, n))
    tv_models.resnet = tv_resnet
    tv.models = tv_models
    sys.modules.setdefault("torchvision", tv)
    sys.modules.setdefault("torchvision.models", tv_models)
    sys.modules.setdefault("torchvision.models.resnet", tv_resnet)

    pkg = types.ModuleType("ref_models_pkg")
    pkg.__path__ = [REF]
    sys.modules["ref_models_pkg"] = pkg
    mods = {}
    for name in ("salsanext", "pmf_net", "epmf_net"):
        spec = importlib.util.spec_from_file_location(
            f"ref_models_pkg.{name}", f"{REF}/{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[f"ref_models_pkg.{name}"] = mod
        spec.loader.exec_module(mod)
        mods[name] = mod
    return mods


def randomize_(module, seed=0):
    """Random-fill every float tensor so BN affine/running-stat conversion
    is actually exercised (default BN init is identity)."""
    g = torch.Generator().manual_seed(seed)
    sd = module.state_dict()
    new = {}
    for k, v in sd.items():
        if v.is_floating_point():
            if k.endswith("running_var"):
                new[k] = torch.rand(v.shape, generator=g) + 0.5
            else:
                new[k] = torch.randn(v.shape, generator=g) * 0.1
        else:
            new[k] = v
    module.load_state_dict(new)
    return module


def to_nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - b)))


def test_salsanext_forward_parity(ref_models):
    import jax.numpy as jnp

    from pmf_tpu.models import SalsaNext
    from pmf_tpu.models.torch_convert import convert_generic_state_dict

    ref = randomize_(ref_models["salsanext"].SalsaNext(
        in_channels=5, nclasses=20, base_channels=32, softmax=True), seed=1)
    ref.eval()
    x = torch.randn(2, 5, 32, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out_t = to_nhwc(ref(x))

    params, stats = convert_generic_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    model = SalsaNext(nclasses=20, base_channels=32, softmax=True)
    out_f = model.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(to_nhwc(x)), train=False)
    assert max_err(out_f, out_t) < 1e-4


def test_pmfnet_forward_parity(ref_models):
    import jax.numpy as jnp

    from pmf_tpu.models import PMFNet
    from pmf_tpu.models.torch_convert import convert_pmf_state_dict

    ref = randomize_(ref_models["pmf_net"].PMFNet(
        pcd_channels=5, img_channels=3, nclasses=20, base_channels=32,
        imagenet_pretrained=False, image_backbone="resnet34"), seed=3)
    ref.eval()
    g = torch.Generator().manual_seed(4)
    pcd = torch.randn(1, 5, 64, 96, generator=g)
    img = torch.randn(1, 3, 64, 96, generator=g)
    with torch.no_grad():
        lidar_t, cam_t = ref(pcd, img)

    params, stats = convert_pmf_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    model = PMFNet(nclasses=20, base_channels=32, image_backbone="resnet34")
    lidar_f, cam_f = model.apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(to_nhwc(pcd)), jnp.asarray(to_nhwc(img)), train=False)
    assert max_err(lidar_f, to_nhwc(lidar_t)) < 1e-4
    assert max_err(cam_f, to_nhwc(cam_t)) < 1e-4


def test_pmfnet_forward_parity_packed(ref_models):
    """Same converted checkpoint through the packed fast path — proves
    checkpoints are interchangeable between packed and unpacked modes."""
    import jax.numpy as jnp

    from pmf_tpu.models import PMFNet
    from pmf_tpu.models.torch_convert import convert_pmf_state_dict

    ref = randomize_(ref_models["pmf_net"].PMFNet(
        pcd_channels=5, img_channels=3, nclasses=20, base_channels=32,
        imagenet_pretrained=False, image_backbone="resnet34"), seed=5)
    ref.eval()
    g = torch.Generator().manual_seed(6)
    pcd = torch.randn(1, 5, 64, 96, generator=g)
    img = torch.randn(1, 3, 64, 96, generator=g)
    with torch.no_grad():
        lidar_t, _ = ref(pcd, img)

    params, stats = convert_pmf_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    model = PMFNet(nclasses=20, base_channels=32, image_backbone="resnet34",
                   use_packed=True)
    lidar_f, _ = model.apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(to_nhwc(pcd)), jnp.asarray(to_nhwc(img)), train=False)
    assert max_err(lidar_f, to_nhwc(lidar_t)) < 1e-4


def test_epmfnet_forward_parity(ref_models):
    import jax.numpy as jnp

    from pmf_tpu.models import EPMFNet
    from pmf_tpu.models.torch_convert import convert_pmf_state_dict

    ref = randomize_(ref_models["epmf_net"].EPMFNet(
        pcd_channels=5, img_channels=3, nclasses=20, base_channels=32,
        imagenet_pretrained=False, image_backbone="resnet34"), seed=7)
    ref.eval()
    g = torch.Generator().manual_seed(8)
    pcd = torch.randn(1, 5, 64, 128, generator=g)
    img = torch.randn(1, 3, 64, 128, generator=g)
    # exercise the sparse-conv mask path: a dead sensor region
    pcd[:, :, :16, :32] = 0.0
    with torch.no_grad():
        lidar_t, cam_t = ref(pcd, img)

    params, stats = convert_pmf_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    model = EPMFNet(nclasses=20, base_channels=32, image_backbone="resnet34")
    lidar_f, cam_f = model.apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(to_nhwc(pcd)), jnp.asarray(to_nhwc(img)), train=False)
    assert max_err(lidar_f, to_nhwc(lidar_t)) < 1e-4
    assert max_err(cam_f, to_nhwc(cam_t)) < 1e-4


def test_epmfnet_forward_parity_packed(ref_models):
    """EPMF perf flags: same converted checkpoint through use_packed."""
    import jax.numpy as jnp

    from pmf_tpu.models import EPMFNet
    from pmf_tpu.models.torch_convert import convert_pmf_state_dict

    ref = randomize_(ref_models["epmf_net"].EPMFNet(
        pcd_channels=5, img_channels=3, nclasses=20, base_channels=32,
        imagenet_pretrained=False, image_backbone="resnet34"), seed=11)
    ref.eval()
    g = torch.Generator().manual_seed(12)
    pcd = torch.randn(1, 5, 64, 128, generator=g)
    img = torch.randn(1, 3, 64, 128, generator=g)
    with torch.no_grad():
        lidar_t, cam_t = ref(pcd, img)

    params, stats = convert_pmf_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    model = EPMFNet(nclasses=20, base_channels=32, image_backbone="resnet34",
                    use_packed=True)
    lidar_f, cam_f = model.apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(to_nhwc(pcd)), jnp.asarray(to_nhwc(img)), train=False)
    assert max_err(lidar_f, to_nhwc(lidar_t)) < 1e-4
    assert max_err(cam_f, to_nhwc(cam_t)) < 1e-4


def test_resnet50_encoder_parity(ref_models):
    """Bottleneck-family coverage (PMF-ResNet50 is a published config)."""
    import jax.numpy as jnp

    from pmf_tpu.models.resnet import ResNetEncoder
    from pmf_tpu.models.torch_convert import convert_resnet_state_dict

    ref = randomize_(ref_models["pmf_net"].ResNet(
        in_channels=3, backbone="resnet50", pretrained=False), seed=9)
    ref.eval()
    x = torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        feats_t = ref(x)

    params, stats = convert_resnet_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    enc = ResNetEncoder(backbone="resnet50")
    feats_f = enc.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(to_nhwc(x)), train=False)
    for f_f, f_t in zip(feats_f, feats_t):
        assert max_err(f_f, to_nhwc(f_t)) < 1e-4
