"""Checkpoints (counterpart of `pmf_tpu/train/checkpoint.py`), with
torch.save:
  * the resume checkpoint {model, optimizer, epoch}, written every epoch to
    `<dir>/checkpoint.pth`;
  * best-per-metric snapshots `<dir>/best_{Acc,IOU,Recall,last}_model.pth`,
    each a plain model state_dict, which `tools/infer_kitti.py --weights`
    loads as it is;
  * `partial_load`, the tolerant load that takes only the tensors whose name
    and shape match.
"""
from __future__ import annotations

import os

import torch


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    @property
    def resume_path(self) -> str:
        return os.path.join(self.directory, "checkpoint.pth")

    def best_path(self, metric: str) -> str:
        return os.path.join(self.directory, f"best_{metric}_model.pth")

    def save(self, model, optimizer, epoch: int):
        _atomic_save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                      "epoch": epoch}, self.resume_path)

    def restore(self, model, optimizer) -> int:
        """Load the resume checkpoint into `model` and `optimizer`; returns
        its epoch."""
        state = torch.load(self.resume_path, map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        return int(state["epoch"])

    def save_best(self, model, metric: str):
        _atomic_save(model.state_dict(), self.best_path(metric))


def _atomic_save(obj, path: str):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def partial_load(target: dict, source: dict, log=None) -> dict:
    """`target` (a state_dict) with each tensor replaced by `source`'s of the
    same name where the shapes match; the rest kept."""
    out, n_hit = {}, 0
    for name, leaf in target.items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(leaf.shape):
            out[name] = src
            n_hit += 1
        else:
            out[name] = leaf
            if log is not None:
                log.info(f"partial_load: skipping {name}")
    if log is not None:
        log.info(f"partial_load: matched {n_hit}/{len(target)} tensors")
    return out
