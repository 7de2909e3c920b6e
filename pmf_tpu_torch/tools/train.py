"""Train PMFNet, EPMFNet or SalsaNext (`net_type`) on SemanticKITTI or
nuScenes, EPMFNet on A2D2 or PMFNet on SensatUrban (`dataset`) (counterpart
of `pmf_tpu/tools/train.py`).

Usage:
  python -m pmf_tpu_torch.tools.train <config.yaml> [--val-only] [--debug]
      [--device cpu|cuda] [--overwrite-policy auto|ask|reuse|delete|abort]
  torchrun --nproc_per_node=N -m pmf_tpu_torch.tools.train <config.yaml>
  torchrun --nproc_per_node=4 -m pmf_tpu_torch.tools.train <config.yaml>  # mesh_model: 2

The run directory is <save_path>/<dataset>-<net>-<backbone>-bs<bs>-lr<lr>-<id>
(Options.run_dir). `--overwrite-policy` (else the config's
`overwrite_policy`, else auto) says what to do when it exists
(config.check_run_dir). The main process writes it (train.Recorder):
settings.json, code/ (the package's sources), log/experiment.log,
log/scalars.jsonl, log/images/, and under checkpoint/ the resume checkpoint
(every epoch) and the best_{Acc,IOU,Recall,last}_model.pth snapshots, which
`tools/infer_kitti.py --weights` loads (SalsaNext's:
`tools/infer_salsanext.py --weights`; A2D2's `tools/infer_a2d2.py`,
SensatUrban's `tools/infer_sensat.py`). `checkpoint: <any value>` in the
config resumes from the run directory's checkpoint, on every process.
--debug runs one iteration per epoch (on nuScenes, from the v1.0-mini DB). A
model starts from pmf_tpu's initialization, drawn after
`torch.manual_seed(seed)`; a fusion net's camera encoder then takes the
torchvision-named ImageNet ResNet weights of `pretrained_weights` (.pth or
.npz) where names and shapes match. The run is on the card unless --device
cpu is given; float32 convolutions there run in float32 (TF32 off).

Data parallelism: one process a device, launched by torchrun (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or with pmf_tpu's
variables (COORDINATOR_ADDRESS, PROCESS_COUNT, PROCESS_ID); NCCL on the
card, gloo with --device cpu. `batch_size` is per device, and each step is
the global batch's (train.Trainer). `mesh_model: M` (M dividing the process
count, `mesh_data` -1 or processes / M) lays the processes out as a (data,
model) grid: each sample's image rows are split over the M ranks of its
model group (parallel/spatial.py), and the global batch is batch_size ×
processes / M.
"""
from __future__ import annotations

import argparse
import datetime
import logging
import os
import time

import numpy as np
import torch

from ..config import check_run_dir, load_options
from ..models import build_model, load_pretrained_resnet
from ..parallel import barrier, data_parallel, init_distributed, make_mesh, shutdown
from ..train import CheckpointManager, Recorder, Trainer
from ..utils import disable_tf32, is_main_process, make_logger, resolve_device

log = logging.getLogger(__name__)


class Experiment:
    """The epoch loop: train, validate every val_frequency epochs and at the
    last, keep the best snapshots, write the resume checkpoint. The main
    process writes; the others wait for it at the end of each epoch."""

    def __init__(self, opts, trainer: Trainer):
        self.opts, self.trainer = opts, trainer
        self.ckpt = CheckpointManager(os.path.join(opts.run_dir, "checkpoint"))
        self.main = is_main_process()
        self.start_epoch = 0
        self.best = {"Acc": 0.0, "IOU": 0.0, "Recall": 0.0}
        if opts.checkpoint:
            epoch = self.ckpt.restore(trainer.model, trainer.optimizer, trainer.mt_sigma,
                                      map_location=trainer.device)
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
                        if self.main:
                            self.ckpt.save_best(trainer.model, k, trainer.mt_sigma)
                        log.info(f"new best {k}: {metrics[k]:.4f}")
                if self.main:
                    self.ckpt.save_best(trainer.model, "last", trainer.mt_sigma)
            if self.main:
                self.ckpt.save(trainer.model, trainer.optimizer, epoch, trainer.mt_sigma)
            barrier()
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
    parser.add_argument("--overwrite-policy", default=None,
                        choices=["auto", "ask", "reuse", "delete", "abort"],
                        help="what to do when the run directory exists (default: the "
                             "config's overwrite_policy, else auto)")
    args = parser.parse_args(argv)
    disable_tf32()
    overrides = {}
    if args.val_only:
        overrides["val_only"] = True
    if args.debug:
        overrides["is_debug"] = True
    opts = load_options(args.config, overrides)
    device = resolve_device(args.device)
    started = not data_parallel()
    recorder = None
    try:
        init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(opts.mesh_data, opts.mesh_model)
        if is_main_process():
            check_run_dir(opts.run_dir, args.overwrite_policy or
                          opts.config.get("overwrite_policy", "auto"))
            recorder = Recorder(opts.run_dir, settings_dict={
                k: v for k, v in vars(opts).items() if k != "config"}, snapshot_code=True)
        else:
            make_logger()
        barrier()
        np.random.seed(opts.seed)
        torch.manual_seed(opts.seed)
        model = build_model(opts)
        if opts.pretrained_weights and opts.net_type != "SalsaNext":
            load_pretrained_resnet(model, opts.pretrained_weights, opts.img_backbone, log=log)
        trainer = Trainer.from_files(opts, model.to(device), device, recorder, mesh)
        return Experiment(opts, trainer).run()
    finally:
        if recorder is not None:
            recorder.close()
        if started:
            shutdown()


if __name__ == "__main__":
    main()
