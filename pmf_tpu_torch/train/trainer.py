"""PMFNet, EPMFNet and SalsaNext training on SemanticKITTI (counterpart of
the PMF, EPMF and SalsaNext branches of `pmf_tpu/train/trainer.py`).

The Trainer batches samples from readers (`reader(i)` → the numpy sample
dict of `data.kitti_sample_reader`, or for SalsaNext of
`data.range_sample_reader`), builds the train view on the device (PMF:
`build_batch`, EPMF: the V2 view `build_v2_batch`, K2 for the canvas and,
with the point-domain Lovász, K1 for the points' winner flags; SalsaNext:
the range view `build_range_batch`, K1 for its z-buffer), and runs the train
step: the model in train mode, the losses (`pmf_losses`, weighted by the
learned multi-task σ with `use_mtloss`; `salsanext_losses`), backward, the
optimizer's update (the hybrid AdamW/SGD; AdamW for SalsaNext), the
confusion matrices. Validation runs the eval view and the eval step.
Per-iteration log lines carry the data and process times, the learning
rate, the loss, Acc/IoU/Recall (and the image stream's for the fusion nets)
and the remaining time.
"""
from __future__ import annotations

import datetime
import logging
import time
from typing import Callable

import numpy as np
import torch

from ..data import (SemanticKitti, build_batch, build_range_batch, build_v2_batch,
                    kitti_sample_reader, range_config, range_sample_reader, view_config)
from ..losses import init_multi_task_params
from ..metrics import IOUEval
from ..utils import AverageMeter, RemainTime
from .optim import HybridOptimizer, adamw
from .schedules import warmup_cosine_lr
from .steps import (LossConfig, make_pmf_eval_step, make_pmf_train_step, make_salsanext_eval_step,
                    make_salsanext_train_step)

log = logging.getLogger(__name__)

TRAIN_SEQUENCES = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10]
VAL_SEQUENCES = [8]
_VIEW_KEYS = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
_RANGE_KEYS = ("points", "labels", "valid")


def kitti_focal_alpha(cls_freq: np.ndarray, learning_ignore: dict) -> np.ndarray:
    """alpha = log(1 + 1/(freq + 1e-3)) / max, ignored classes and class 0
    at 0."""
    w = 1.0 / (cls_freq + 1e-3)
    for cl in range(len(w)):
        if learning_ignore.get(cl, False):
            w[cl] = 0.0
    alpha = np.log(1 + w)
    alpha = alpha / alpha.max()
    alpha[0] = 0.0
    return alpha.astype(np.float32)


def config_focal_alpha(cls_freq) -> np.ndarray:
    """alpha from a raw per-class count list (the config's `cls_freq`):
    normalized, class 0 zeroed, log-weighted."""
    f = np.asarray(cls_freq, dtype=np.float64)
    f = f / f.sum()
    f[0] = 0
    alpha = np.log(1 + 1.0 / (f + 1e-8))
    alpha = alpha / alpha.max()
    alpha[0] = 0.0
    return alpha.astype(np.float32)


def batches(reader: Callable[[int], dict], n: int, batch_size: int, shuffle: bool,
            seed: int = 0, epoch: int = 0):
    """Stacked numpy batches of `reader`'s samples. Train batches are
    shuffled per epoch (seed + epoch) and a short last batch is dropped; the
    last validation batch is padded with its last sample, and
    `batch_valid` [B] marks the real ones."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    n_batches = n // batch_size if shuffle else -(-n // batch_size)
    for b in range(n_batches):
        samples = [reader(int(i)) for i in idx[b * batch_size:(b + 1) * batch_size]]
        n_real = len(samples)
        samples += [samples[-1]] * (batch_size - n_real)
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["batch_valid"] = np.arange(batch_size) < n_real
        yield batch


class Trainer:
    """`model` (a PMFNet, EPMFNet or SalsaNext on `device`) trained on
    `n_train` samples of `train_reader` and validated on `n_val` samples of
    `val_reader`, with focal weights `alpha` [C] (classes of weight 0 are
    left out of the IoU). With `use_mtloss` in the config the six loss terms
    of a fusion net are weighted by `mt_sigma`, trained with the lidar
    stream. Random draws (the train view, dropout) come from one generator
    on the device, seeded by opts.seed."""

    def __init__(self, opts, model, train_reader: Callable[[int], dict], n_train: int,
                 val_reader: Callable[[int], dict], n_val: int, device: torch.device,
                 alpha, class_names: dict | None = None):
        self.opts, self.model, self.device = opts, model, device
        self.readers = {"Train": (train_reader, n_train), "Validation": (val_reader, n_val)}
        self.is_range = opts.net_type == "SalsaNext"
        self.view_cfg = range_config(opts) if self.is_range else view_config(opts)
        self.build = build_v2_batch if opts.net_type == "EPMFNet" else build_batch
        self.class_names = class_names or {}
        self.point_lovasz = bool(opts.config.get("point_lovasz", True)) and not self.is_range
        use_mtloss = bool(opts.config.get("use_mtloss")) and not self.is_range
        self.mt_sigma = torch.nn.Parameter(init_multi_task_params(6, device)) \
            if use_mtloss else None
        steps_per_epoch = max(self.n_batches("Train"), 1)
        self.lr_schedule = warmup_cosine_lr(
            opts.lr, opts.warmup_epochs * steps_per_epoch,
            (opts.n_epochs - opts.warmup_epochs) * steps_per_epoch)
        self.loss_cfg = LossConfig(nclasses=opts.nclasses, alpha=tuple(float(a) for a in alpha),
                                   lambda_=opts.lambda_, gamma=opts.gamma, tau=opts.tau,
                                   use_mtloss=use_mtloss)
        if self.is_range:
            self.optimizer = adamw(model, self.lr_schedule)
            self.train_step = make_salsanext_train_step(model, self.optimizer, self.loss_cfg)
            self.eval_step = make_salsanext_eval_step(model, self.loss_cfg)
        else:
            self.optimizer = HybridOptimizer(model, self.lr_schedule, opts.momentum,
                                             opts.weight_decay,
                                             extra=[self.mt_sigma] if use_mtloss else [])
            self.train_step = make_pmf_train_step(model, self.optimizer, self.loss_cfg,
                                                  self.mt_sigma)
            self.eval_step = make_pmf_eval_step(model, self.loss_cfg, self.mt_sigma)
        ignore = [cl for cl, a in enumerate(alpha) if a == 0]
        self.metrics = IOUEval(opts.nclasses, ignore=ignore)
        self.metrics_img = IOUEval(opts.nclasses, ignore=ignore)
        self.remain_time = RemainTime(opts.n_epochs)
        self.generator = torch.Generator(device=device).manual_seed(opts.seed)

    @classmethod
    def from_files(cls, opts, model, device: torch.device) -> "Trainer":
        """SemanticKITTI under opts.data_root: sequences 00-07, 09, 10 to
        train on, 08 to validate on (SalsaNext reads no images); alpha from
        the config's `cls_freq`, or from the class-map YAML's content
        frequencies."""
        if opts.dataset != "SemanticKitti":
            raise NotImplementedError(f"dataset {opts.dataset} is not ported yet")
        is_range = opts.net_type == "SalsaNext"
        trainset = SemanticKitti(opts.data_root, TRAIN_SEQUENCES, has_image=not is_range)
        valset = SemanticKitti(opts.data_root, VAL_SEQUENCES, has_image=not is_range)
        if opts.config.get("cls_freq"):
            alpha = config_focal_alpha(opts.config["cls_freq"])
        else:
            alpha = kitti_focal_alpha(trainset.cls_freq, trainset.learning_ignore)
        if is_range:
            reader, cfg = range_sample_reader, range_config(opts)
        else:
            reader, cfg = kitti_sample_reader, view_config(opts)
        return cls(opts, model, reader(trainset, cfg), len(trainset), reader(valset, cfg),
                   len(valset), device, alpha, trainset.mapped_cls_name)

    def n_batches(self, mode: str) -> int:
        bs = self.opts.batch_size[0 if mode == "Train" else 1]
        n = self.readers[mode][1]
        return n // bs if mode == "Train" else -(-n // bs)

    def view(self, t: dict, train: bool):
        """The train or eval view of a batch of device tensors `t` (by the
        readers' keys): (feature, label, points), where points are the
        winner flags of the point-domain Lovász or None."""
        with torch.no_grad():
            if self.is_range:
                feature, label, _ = build_range_batch(t["points"], t["labels"], t["valid"],
                                                      self.view_cfg, train, self.generator)
                return feature, label, None
            feature, _, label, *points = self.build(
                *(t[k] for k in _VIEW_KEYS), self.view_cfg, train, self.generator,
                return_points=self.point_lovasz)
        return feature, label, points[0] if points else None

    def _step(self, batch: dict, train: bool) -> dict:
        keys = _RANGE_KEYS if self.is_range else _VIEW_KEYS
        feature, label, points = self.view(
            {k: torch.from_numpy(batch[k]).to(self.device) for k in keys}, train)
        extra = () if self.is_range else (points,)
        if train:
            return self.train_step(feature, label, self.generator, *extra)
        valid = torch.from_numpy(batch["batch_valid"]).to(self.device)
        return self.eval_step(feature, label, valid, *extra)[0]

    def _drain(self, pending: list, loss_meter, aux_meters) -> float:
        """Read the pending steps' device results (this waits for them)."""
        loss = float("nan")
        for aux, n in pending:
            loss = float(aux["loss"])
            loss_meter.update(loss, n)
            for k, v in aux.items():
                if k not in ("loss", "conf", "conf_cam"):
                    aux_meters.setdefault(k, AverageMeter()).update(float(v), n)
            self.metrics.addBatchConf(aux["conf"])
            if "conf_cam" in aux:
                self.metrics_img.addBatchConf(aux["conf_cam"])
        pending.clear()
        return loss

    def run(self, epoch: int, mode: str = "Train") -> dict:
        """One epoch of `mode` ("Train" or "Validation"): returns the mean
        Acc, IOU, Recall of the lidar stream, for the fusion nets the image
        stream's ImgAcc, ImgIOU, ImgRecall, and the mean of each loss
        term."""
        train = mode == "Train"
        reader, n = self.readers[mode]
        bs = self.opts.batch_size[0 if train else 1]
        self.metrics.reset()
        self.metrics_img.reset()
        loss_meter, aux_meters = AverageMeter(), {}
        total_iter = self.n_batches(mode)
        pending: list = []
        loss = float("nan")
        t_start = time.time()
        for i, batch in enumerate(batches(reader, n, bs, train, self.opts.seed, epoch)):
            t_proc = time.time()
            pending.append((self._step(batch, train), int(batch["batch_valid"].sum())))
            data_t, proc_t = t_proc - t_start, time.time() - t_proc
            self.remain_time.update(time.time() - t_start, mode)
            t_start = time.time()
            if i % 10 == 0 or i == total_iter - 1:
                loss = self._drain(pending, loss_meter, aux_meters)
                rt = datetime.timedelta(seconds=int(
                    self.remain_time.getRemainTime(epoch, i, total_iter, mode)))
                line = (f">>> {mode} E[{self.opts.n_epochs:03d}|{epoch + 1:03d}] "
                        f"I[{total_iter:04d}|{i + 1:04d}] DT[{data_t:.3f}] PT[{proc_t:.3f}] "
                        f"LR {self.optimizer.lr:.5f} Loss {loss:.4f} "
                        f"Acc {self.metrics.getAcc()[0]:.4f} IOU {self.metrics.getIoU()[0]:.4f} "
                        f"Recall {self.metrics.getRecall()[0]:.4f}")
                if "entropy" in aux_meters:
                    line += f" Entropy {aux_meters['entropy'].avg:.4f}"
                if not self.is_range:
                    line += (f" ImgAcc {self.metrics_img.getAcc()[0]:.4f} "
                             f"ImgIOU {self.metrics_img.getIoU()[0]:.4f} "
                             f"ImgRecall {self.metrics_img.getRecall()[0]:.4f}")
                if "entropy_cam" in aux_meters:
                    line += f" ImgEntropy {aux_meters['entropy_cam'].avg:.4f}"
                log.info(f"{line} RT {rt}")
            if self.opts.is_debug:
                break
        self._drain(pending, loss_meter, aux_meters)
        out = {"Acc": float(self.metrics.getAcc()[0]), "IOU": float(self.metrics.getIoU()[0]),
               "Recall": float(self.metrics.getRecall()[0]), "last": 0.0}
        if not self.is_range:
            out.update(ImgAcc=float(self.metrics_img.getAcc()[0]),
                       ImgIOU=float(self.metrics_img.getIoU()[0]),
                       ImgRecall=float(self.metrics_img.getRecall()[0]))
        out.update(Loss=loss_meter.avg, **{k: m.avg for k, m in aux_meters.items()})
        log.info(f"{mode} epoch {epoch}: " + " ".join(f"{k} {v:.4f}" for k, v in out.items()))
        return out
