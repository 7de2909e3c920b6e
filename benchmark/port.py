"""The calls the drivers make into the port, and the reference beside each:
the nets made and loaded with the seed's weights, and the views.

The port is driven only through its own entry points; the reference is
`benchmark/reference/`, loaded with the same weights.
"""
from __future__ import annotations

import torch

from .inputs import weights
from .reference import nets as ref_nets
from .reference.view import View


def template(cfg: dict) -> dict:
    """The nets' state_dict keys and shapes (the reference's names are the
    port's), on the meta device."""
    with torch.device("meta"):
        return ref_nets.NETS[cfg["net"]](cfg["nclasses"], cfg["base_channels"]).state_dict()


def make_weights(cfg: dict, seed: int, dev) -> dict:
    return weights(template(cfg), seed, dev)


def program_model(cfg: dict, sd: dict, dev, train: bool):
    """The port's net in the configuration's compute dtype, made on `dev`
    and loaded with `sd`."""
    from pmf_tpu_torch.models import EPMFNet, PMFNet

    net = {"PMFNet": PMFNet, "EPMFNet": EPMFNet}[cfg["net"]]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]
    with torch.device(dev):
        model = net(nclasses=cfg["nclasses"], base_channels=cfg["base_channels"],
                    image_backbone=cfg["img_backbone"], dropout_rate=cfg["dropout_rate"],
                    dtype=dtype)
    model.load_state_dict(sd)
    return model.train(train)


def reference_model(cfg: dict, sd: dict, dev, train: bool, fp8: bool = False):
    """The reference net in float32 (the control with `fp8`), loaded with `sd`."""
    with torch.device(dev):
        model = ref_nets.NETS[cfg["net"]](cfg["nclasses"], cfg["base_channels"],
                                          cfg["dropout_rate"])
    model.load_state_dict(sd)
    ref_nets.set_fp8(model, fp8)
    return model.train(train)


def program_view_config(cfg: dict):
    """The port's view configuration (PVConfig, or V2Config for EPMF)."""
    from pmf_tpu_torch.data import PVConfig, V2Config

    v = {k: tuple(x) if isinstance(x, list) else x for k, x in cfg["view"].items()}
    return V2Config(**v) if cfg["net"] == "EPMFNet" else PVConfig(**v)


def reference_view(cfg: dict) -> View:
    return View.from_dict(cfg["view"])
