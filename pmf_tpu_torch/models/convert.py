"""Carry weights from the JAX package's flax trees into the port's modules.

The inverse of `pmf_tpu.models.torch_convert` (convert_pmf_state_dict,
convert_generic_state_dict): given the `{"params", "batch_stats"}` trees as
nested dicts of numpy arrays, build the port model's state_dict.

  conv:  flax .../Conv_0/{kernel [Kh, Kw, I, O], bias} → weight [O, I, Kh, Kw], bias
  BN:    flax .../BatchNorm_0/{scale, bias} and batch_stats {mean, var} →
         weight, bias, running_mean, running_var
  names: torchvision ResNet layer{s}.{i}.conv{j} ↔ flax layer{s}_{i}/conv{j},
         downsample.{0,1} ↔ downsample_{conv,bn}; nn.Sequential indices of
         the fusion blocks, the RGB decoders and EPMF's extraUpSample ↔
         flax submodule names
  EPMF:  a SparseVariantConv's extra bias .../conv{i}.bias ↔ flax
         .../conv{i}/bias (its Conv is .../conv{i}/conv/Conv_0)

`random_weights` fills a model from a seed instead, for runs without a
checkpoint, and `load_pretrained_resnet` loads torchvision's ImageNet ResNet
weights into a fusion net's camera encoder.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .epmf import SparseVariantConv
from .resnet import ResNetEncoder

# (parent module, nn.Sequential index) → flax submodule name
_SEQ_NAMES = {
    ("fuse_conv", "0"): "fuse_conv", ("fuse_conv", "2"): "fuse_bn",
    ("attention", "0"): "att_conv1", ("attention", "1"): "att_bn1",
    ("attention", "3"): "att_conv2", ("attention", "4"): "att_bn2",
    **{(f"up_{i}a", "0"): f"up_{i}a_conv" for i in (1, 2, 3, 4)},
    **{(f"up_{i}a", "2"): f"up_{i}a_bn" for i in (1, 2, 3, 4)},
    # EPMF's extraUpSample: nn.Sequential(conv, LReLU, BN, PixelShuffle) ↔
    # the flax module extraUpSample/{conv,bn}
    ("extraUpSample", "0"): ("extraUpSample", "conv"),
    ("extraUpSample", "2"): ("extraUpSample", "bn"),
}


def _generic_path(parts) -> list:
    out: list = []
    for p in parts:
        if out and (out[-1], p) in _SEQ_NAMES:
            new = _SEQ_NAMES[(out[-1], p)]
            out[-1:] = [new] if isinstance(new, str) else list(new)
        else:
            out.append(p)
    return out


def _resnet_path(parts) -> list:
    if not parts[0].startswith("layer"):
        return list(parts)                                   # conv1, bn1
    block = f"{parts[0]}_{parts[1]}"
    if parts[2] == "downsample":
        return [block, "downsample_conv" if parts[3] == "0" else "downsample_bn"]
    return [block, parts[2]]


def flax_path(name: str, encoders) -> tuple:
    """Flax path of the port module called `name`; `encoders` names the
    ResNetEncoder submodules ("" when the root is one)."""
    for enc in encoders:
        if enc == "" or name.startswith(enc + "."):
            rest = name[len(enc) + 1:] if enc else name
            head = _generic_path(enc.split(".")) if enc else []
            return tuple(head + _resnet_path(rest.split(".")))
    return tuple(_generic_path(name.split(".")))


def _leaf(tree: dict, path: tuple) -> torch.Tensor:
    node = tree
    for p in path:
        node = node[p]
    return torch.from_numpy(np.asarray(node, dtype=np.float32).copy())


def state_dict_from_flax(model: nn.Module, params: dict,
                         batch_stats: dict) -> dict:
    """The port model's state_dict with every conv and BN tensor, and the
    extra bias of each SparseVariantConv, taken from the flax trees."""
    encoders = [n for n, m in model.named_modules() if isinstance(m, ResNetEncoder)]
    sd = dict(model.state_dict())
    for name, m in model.named_modules():
        if isinstance(m, SparseVariantConv):
            sd[f"{name}.bias"] = _leaf(params, flax_path(name, encoders) + ("bias",))
        elif isinstance(m, nn.Conv2d):
            path = flax_path(name, encoders) + ("Conv_0",)
            sd[f"{name}.weight"] = _leaf(params, path + ("kernel",)).permute(3, 2, 0, 1)
            if m.bias is not None:
                sd[f"{name}.bias"] = _leaf(params, path + ("bias",))
        elif isinstance(m, nn.BatchNorm2d):
            path = flax_path(name, encoders) + ("BatchNorm_0",)
            sd[f"{name}.weight"] = _leaf(params, path + ("scale",))
            sd[f"{name}.bias"] = _leaf(params, path + ("bias",))
            sd[f"{name}.running_mean"] = _leaf(batch_stats, path + ("mean",))
            sd[f"{name}.running_var"] = _leaf(batch_stats, path + ("var",))
    return {k: v.contiguous() for k, v in sd.items()}


def read_flax_npz(path: str) -> tuple[dict, dict]:
    """(params, batch_stats) from an .npz of the flat flax tree: one array
    per leaf, keyed by its '/'-joined path ('params/lidar_stream/.../kernel',
    'batch_stats/.../mean')."""
    trees: dict = {"params": {}, "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = trees
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return trees["params"], trees["batch_stats"]


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Load `path` into `model`: a `.pth` torch state_dict with the
    reference's (pc_processor) names, or an `.npz` of the flat flax tree.
    The multi-task loss weights `mt_sigma` that a trainer's snapshot carries
    beside the model's tensors are not the model's, and are left out."""
    if path.endswith(".npz"):
        sd = state_dict_from_flax(model, *read_flax_npz(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd.pop("mt_sigma", None)
    model.load_state_dict(sd)
    return model


def random_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every float tensor of `model` from `seed` and put it in eval mode.

    Conv kernels are N(0, 1/fan_in), BN scales and running variances
    U(0.5, 1.5), the other vectors (biases, running means) N(0, 0.1²). Each
    layer then keeps its input's scale, so the class probabilities depend on
    the input (smaller kernels give every pixel the same class)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            sd[k] = v
        elif v.dim() == 4:
            sd[k] = torch.randn(v.shape, generator=g) / math.sqrt(v[0].numel())
        elif k.endswith(("running_var", "weight")):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    model.load_state_dict(sd)
    return model.eval()


def read_state_dict(path: str) -> dict:
    """A torch state_dict from a `.pth` (tensors only, or a module) or an
    `.npz` with the same keys, as tensors."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_pretrained_resnet(model: nn.Module, path: str, backbone: str = "resnet34",
                           log=None, encoder: str = "camera_stream_encoder") -> nn.Module:
    """Load a torchvision-named ResNet state_dict (the ImageNet weights of
    `backbone`, which names them as in pmf_tpu's signature: conv1, bn1,
    layer{s}.{i}..., fc) into `model.<encoder>`, as pmf_tpu's
    load_pretrained_resnet_into does: through `partial_load`, so only
    tensors whose name and shape match load (the others are logged to `log`
    and kept; `fc.*` has no counterpart), and torchvision's
    `num_batches_tracked` counters are left out."""
    from ..train.checkpoint import partial_load

    sd = {k: v for k, v in read_state_dict(path).items()
          if not k.endswith("num_batches_tracked")}
    enc = getattr(model, encoder)
    target = {k: v for k, v in enc.state_dict().items() if not k.endswith("num_batches_tracked")}
    enc.load_state_dict(partial_load(target, sd, log), strict=False)
    return model
