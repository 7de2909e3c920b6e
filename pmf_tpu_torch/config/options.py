"""Typed experiment configuration (counterpart of
`pmf_tpu/config/options.py`): one YAML per experiment, the typed fields the
port reads, and the raw dict as `.config` for the nested groups (sensor,
post)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class Options:
    config: dict = field(default_factory=dict)
    dataset: str = "SemanticKitti"
    nclasses: int = 20
    data_root: str = ""
    net_type: str = "PMFNet"
    compute_dtype: str = "float32"  # float32 | bfloat16 (params stay f32)
    base_channels: int = 32
    img_backbone: str = "resnet34"

    def group(self, key: str, default=None) -> Any:
        return self.config.get(key, default if default is not None else {})


def load_options(path: str, overrides: dict | None = None) -> Options:
    """Options from a YAML file (keys the port does not read are kept in
    `.config` only)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    opts = Options(config=raw)
    fields = set(Options.__dataclass_fields__) - {"config"}
    for k, v in {**raw, **(overrides or {})}.items():
        if k in fields:
            setattr(opts, k, v)
    return opts
