"""The run directory's records (counterpart of `pmf_tpu/train/recorder.py`).

<run_dir>/
  settings.json           the options the run was started with
  code/pmf_tpu_torch/...  a copy of the port's sources (.py, .yaml, .sh)
  log/experiment.log      the package's log (make_logger)
  log/scalars.jsonl       one {"tag", "value", "step", "time"} line a scalar
  log/images/*.png        image panels (add_image)
  checkpoint/             the trainer's checkpoints
and a TensorBoard event file under log/ when torch.utils.tensorboard
imports. Only the main process writes; elsewhere the Recorder keeps the
paths and writes nothing.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from ..utils.logger import is_main_process, make_logger

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recorder:
    def __init__(self, save_path: str, settings_dict: dict | None = None,
                 snapshot_code: bool = False, use_tensorboard: bool = True):
        self.save_path = os.path.abspath(save_path)
        self.is_main = is_main_process()
        self.log_dir = os.path.join(self.save_path, "log")
        self.checkpoint_dir = os.path.join(self.save_path, "checkpoint")
        self.code_dir = os.path.join(self.save_path, "code")
        self.logger = make_logger("pmf_tpu_torch", os.path.join(self.log_dir, "experiment.log")
                                  if self.is_main else None)
        self._scalar_file = None
        self.tensorboard = None
        if not self.is_main:
            return
        for d in (self.log_dir, self.checkpoint_dir):
            os.makedirs(d, exist_ok=True)
        self._scalar_file = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        if settings_dict is not None:
            with open(os.path.join(self.save_path, "settings.json"), "w") as f:
                json.dump(settings_dict, f, indent=2, default=str)
        if snapshot_code:
            self._snapshot_code()
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self.tensorboard = SummaryWriter(self.log_dir)

    def _snapshot_code(self, extensions=(".py", ".yaml", ".sh")):
        """Copy the package's sources to code/pmf_tpu_torch/."""
        for dirpath, _, files in os.walk(PACKAGE_ROOT):
            for fn in files:
                if fn.endswith(extensions):
                    src = os.path.join(dirpath, fn)
                    dst = os.path.join(self.code_dir,
                                       os.path.relpath(src, os.path.dirname(PACKAGE_ROOT)))
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copy2(src, dst)

    def add_image(self, tag: str, image, step: int):
        """An [H, W] or [H, W, 3] float panel, min-max normalized, as
        log/images/{tag}_{step:04d}.png (a '/' of the tag, as in A2D2's class
        names, written '-') and to TensorBoard."""
        if not self.is_main:
            return
        img = np.asarray(image, np.float32)
        lo, hi = float(img.min()), float(img.max())
        if hi > lo:
            img = (img - lo) / (hi - lo)
        d = os.path.join(self.log_dir, "images")
        os.makedirs(d, exist_ok=True)
        from PIL import Image

        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(d, f"{tag.replace('/', '-')}_{step:04d}.png"))
        if self.tensorboard is not None:
            self.tensorboard.add_image(tag, img[None] if img.ndim == 2 else
                                       img.transpose(2, 0, 1), step)

    def add_scalar(self, tag: str, value, step: int):
        if self._scalar_file is not None:
            self._scalar_file.write(json.dumps({"tag": tag, "value": float(value),
                                                "step": int(step), "time": time.time()}) + "\n")
            self._scalar_file.flush()
        if self.tensorboard is not None:
            self.tensorboard.add_scalar(tag, float(value), step)

    def close(self):
        """Close the scalar stream, TensorBoard and the log file."""
        if self._scalar_file is not None:
            self._scalar_file.close()
            self._scalar_file = None
        if self.tensorboard is not None:
            self.tensorboard.close()
            self.tensorboard = None
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
