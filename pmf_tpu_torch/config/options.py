"""Typed experiment configuration (counterpart of
`pmf_tpu/config/options.py`): one YAML per experiment, the typed fields the
port reads, and the raw dict as `.config` for the nested groups (sensor,
augmentation, post)."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Options:
    config: dict = field(default_factory=dict)

    # common
    save_path: str = "./experiments"
    seed: int = 1
    print_frequency: int = 2   # image panels every this many epochs
    n_threads: int = 8         # the host loader's reader threads
    experiment_id: str = "baseline"

    # run control
    val_only: bool = False
    has_label: bool = True
    is_debug: bool = False     # one iteration per epoch
    n_epochs: int = 50
    batch_size: tuple = (2, 4)  # (train, val)
    lr: float = 0.001
    warmup_epochs: int = 1
    momentum: float = 0.9
    weight_decay: float = 1e-5
    val_frequency: int = 1

    # data
    dataset: str = "SemanticKitti"
    nclasses: int = 20
    data_root: str = ""

    # model
    net_type: str = "PMFNet"
    compute_dtype: str = "float32"  # float32 | bfloat16 (params stay f32)
    base_channels: int = 32
    img_backbone: str = "resnet34"
    imagenet_pretrained: bool = False
    pretrained_weights: str = ""    # torchvision-named ResNet state_dict (.pth or .npz)

    # loss
    lambda_: float = 1.0
    gamma: float = 0.5
    tau: float = 0.7

    # checkpoints
    checkpoint: str | None = None   # set: resume from <run_dir>/checkpoint
    pretrained_model: str | None = None

    # parallelism: processes on the data axis (-1: all), the model axis (1)
    mesh_data: int = -1
    mesh_model: int = 1

    @property
    def run_dir(self) -> str:
        """<save_path>/<dataset>-<net>-<backbone>-bs<train bs>-lr<lr>-<id>."""
        name = "-".join([self.dataset, self.net_type, self.img_backbone,
                         f"bs{self.batch_size[0]}", f"lr{self.lr}", self.experiment_id])
        return os.path.join(self.save_path, name)

    def group(self, key: str, default=None) -> Any:
        return self.config.get(key, default if default is not None else {})


_RENAMES = {"lambda": "lambda_"}


def check_run_dir(run_dir: str, policy: str = "auto") -> None:
    """What to do when the run directory exists (pmf_tpu's guard):

      auto   — ask when stdin is a terminal, else warn and reuse it;
      ask    — prompt d(delete) / q(quit);
      reuse  — go on in the existing directory;
      delete — remove it;
      abort  — raise OSError.
    """
    import shutil
    import sys

    if not os.path.exists(run_dir):
        return
    if policy == "auto":
        policy = "ask" if sys.stdin.isatty() else "reuse"
        if policy == "reuse":
            print(f"warning: reusing existing run dir {run_dir} "
                  "(set overwrite_policy: delete/abort to change)", file=sys.stderr)
            return
    if policy == "reuse":
        return
    if policy == "ask":
        print(f"file exist: {run_dir}")
        action = input("Select Action: d(delete) / q(quit): ").lower().strip()
        policy = "delete" if action == "d" else "abort"
    if policy == "delete":
        shutil.rmtree(run_dir)
        return
    raise OSError(f"Directory exists: {run_dir}")


def load_options(path: str, overrides: dict | None = None) -> Options:
    """Options from a YAML file (keys the port does not read are kept in
    `.config` only)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    opts = Options(config=raw)
    fields = set(Options.__dataclass_fields__) - {"config"}
    for k, v in {**raw, **(overrides or {})}.items():
        k = _RENAMES.get(k, k)
        if k in fields:
            setattr(opts, k, tuple(v) if k == "batch_size" else v)
    return opts
