"""Train PMFNet, EPMFNet or SalsaNext (`net_type`) on SemanticKITTI or
nuScenes, EPMFNet on A2D2 or PMFNet on SensatUrban (`dataset`) (counterpart
of `pmf_tpu/tools/train.py`).

Usage:
  python -m pmf_tpu_torch.tools.train <config.yaml> [--val-only] [--debug]
      [--device cpu|cuda]

The run directory is <save_path>/<dataset>-<net>-<backbone>-bs<bs>-lr<lr>-<id>
(Options.run_dir): log/experiment.log, and under checkpoint/ the resume
checkpoint (every epoch) and the best_{Acc,IOU,Recall,last}_model.pth
snapshots, which `tools/infer_kitti.py --weights` loads (SalsaNext's:
`tools/infer_salsanext.py --weights`; A2D2's `tools/infer_a2d2.py`,
SensatUrban's `tools/infer_sensat.py`). `checkpoint: <any
value>` in the config resumes from the run directory's checkpoint. --debug
runs one iteration per epoch (on nuScenes, from the v1.0-mini DB). A model
without `pretrained_weights` starts from pmf_tpu's initialization, drawn
after `torch.manual_seed(seed)`. The run is on the card unless --device cpu is
given; float32 convolutions there run in float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import datetime
import logging
import os
import time

import numpy as np
import torch

from ..config import load_options
from ..models import build_model
from ..train import CheckpointManager, Trainer
from ..utils import disable_tf32, resolve_device

log = logging.getLogger(__name__)


class Experiment:
    """The epoch loop: train, validate every val_frequency epochs and at the
    last, keep the best snapshots, write the resume checkpoint."""

    def __init__(self, opts, trainer: Trainer):
        self.opts, self.trainer = opts, trainer
        self.ckpt = CheckpointManager(os.path.join(opts.run_dir, "checkpoint"))
        self.start_epoch = 0
        self.best = {"Acc": 0.0, "IOU": 0.0, "Recall": 0.0}
        if opts.checkpoint:
            epoch = self.ckpt.restore(trainer.model, trainer.optimizer, trainer.mt_sigma)
            self.start_epoch = epoch + 1
            log.info(f"resumed from epoch {epoch}")

    def run(self) -> dict:
        opts, trainer = self.opts, self.trainer
        t0 = time.time()
        if opts.val_only:
            metrics = trainer.run(0, "Validation")
            log.info(f"val-only metrics: {metrics}")
            return metrics
        for epoch in range(self.start_epoch, opts.n_epochs):
            trainer.run(epoch, "Train")
            if (epoch % opts.val_frequency == 0 or epoch == opts.n_epochs - 1) \
                    and opts.has_label:
                metrics = trainer.run(epoch, "Validation")
                for k in ("Acc", "IOU", "Recall"):
                    if metrics[k] > self.best[k]:
                        self.best[k] = metrics[k]
                        self.ckpt.save_best(trainer.model, k, trainer.mt_sigma)
                        log.info(f"new best {k}: {metrics[k]:.4f}")
                self.ckpt.save_best(trainer.model, "last", trainer.mt_sigma)
            self.ckpt.save(trainer.model, trainer.optimizer, epoch, trainer.mt_sigma)
            cost = datetime.timedelta(seconds=int(time.time() - t0))
            log.info(f"epoch {epoch} done; elapsed {cost}; best {self.best}")
        log.info(f"training done; best {self.best}")
        return self.best


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--val-only", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    disable_tf32()
    overrides = {}
    if args.val_only:
        overrides["val_only"] = True
    if args.debug:
        overrides["is_debug"] = True
    opts = load_options(args.config, overrides)
    device = resolve_device(args.device)
    if opts.pretrained_weights:
        raise NotImplementedError("loading ImageNet ResNet weights is not ported yet")

    log_dir = os.path.join(opts.run_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    logging.basicConfig(format="%(asctime)s %(message)s")
    handler = logging.FileHandler(os.path.join(log_dir, "experiment.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    package_log = logging.getLogger("pmf_tpu_torch")
    package_log.setLevel(logging.INFO)
    package_log.addHandler(handler)
    np.random.seed(opts.seed)
    torch.manual_seed(opts.seed)
    model = build_model(opts).to(device)
    try:
        return Experiment(opts, Trainer.from_files(opts, model, device)).run()
    finally:
        package_log.removeHandler(handler)
        handler.close()


if __name__ == "__main__":
    main()
