"""PMFNet, EPMFNet and SalsaNext training on SemanticKITTI and nuScenes,
EPMFNet on A2D2 and PMFNet on SensatUrban (counterpart of
`pmf_tpu/train/trainer.py`).

The Trainer batches samples from readers (`reader(i)` → the numpy sample
dict of `data.kitti_sample_reader`, `data.nuscenes_sample_reader` or
`data.a2d2_sample_reader`, for SalsaNext of `data.range_sample_reader`, for
SensatUrban of `data.sensat_sample_reader`), builds the train view on the
device (PMF: `build_batch`, EPMF: the V2 view `build_v2_batch`, on A2D2's
stored pixels `build_v2_batch_pix`, K2 for the canvas and, with the
point-domain Lovász, K1 for the points' winner flags; SalsaNext: the range
view `build_range_batch`, K1 for its z-buffer; SensatUrban: the BEV crop
`build_sensat_batch`, no kernel), and runs the train step: the model in
train mode, the losses (`pmf_losses`, weighted by the learned multi-task σ
with `use_mtloss`, with ExpLogDice on SensatUrban; `salsanext_losses`),
backward, the optimizer's update (the hybrid AdamW/SGD, its AdamW group
with AMSGrad on SensatUrban; AdamW for SalsaNext), the confusion
matrices. Validation runs the eval view and the eval step.
Per-iteration log lines carry the data and process times, the learning
rate, the loss, Acc/IoU/Recall (and the image stream's for the fusion nets)
and the remaining time.

The samples come in batches from `HostLoader`, `opts.n_threads` reader
threads ahead of the step. While a process group is up each process reads
its shard of every epoch (`HostLoader`'s `idx[rank::world]`) in batches of
`batch_size` per device, and the steps take the global batch's losses, BN
statistics, draws and confusion matrices (`parallel/collectives.py`). Every
process runs the same count of steps: (n // world) // batch_size a train
epoch, and ceil(ceil(n / world) / batch_size) validation batches, a process
whose shard is used up running all-invalid batches, so that the collectives
line up.

With a (data, model) `mesh` of model size M > 1 (`mesh_model`), the M ranks
of a model group read the same shard (the data index's) and build the same
view, then each runs the step on its block of the view's rows
(`parallel.spatial`): the global batch is batch_size × world / M samples,
each split over a model group's M ranks.

With a `Recorder` (the main process's) each epoch's means go to its scalar
stream under pmf_tpu's tags, and every `print_frequency` epochs the fusion
nets (not on nuScenes) write image panels of the last batch's first sample.
"""
from __future__ import annotations

import contextlib
import datetime
import logging
import os
import time
from typing import Callable

import numpy as np
import torch

from ..data import (A2D2_PV, HostLoader, Nuscenes, SemanticKitti, SensatUrban, a2d2_sample_reader,
                    build_batch, build_range_batch, build_sensat_batch, build_v2_batch,
                    build_v2_batch_pix, kitti_sample_reader, nuscenes_sample_reader,
                    range_config, range_sample_reader, sensat_config, sensat_frame_weights,
                    sensat_sample_reader, view_config)
from ..data.perspective_pipeline_v2 import A2D2_NAMES
from ..losses import init_multi_task_params
from ..metrics import IOUEval
from ..parallel import broadcast_state, spatial, world
from ..utils import AverageMeter, RemainTime
from ..utils.spans import span
from .optim import HybridOptimizer, adamw
from .schedules import warmup_cosine_lr
from .steps import (LossConfig, make_pmf_eval_step, make_pmf_train_step, make_salsanext_eval_step,
                    make_salsanext_train_step)

log = logging.getLogger(__name__)

TRAIN_SEQUENCES = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10]
VAL_SEQUENCES = [8]
_VIEW_KEYS = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
_PIX_KEYS = ("points", "labels", "valid", "rows", "cols", "image", "img_h", "img_w")
_RANGE_KEYS = ("points", "labels", "valid")
_SENSAT_KEYS = ("feature_map", "label_map")
SENSAT_RARE_ALPHA = {4: 2.0, 5: 2.5, 7: 3.0, 12: 10.0, 13: 2.5}
# the scalar tags of the step's loss terms (pmf_tpu's trainer)
SCALAR_TAGS = {"loss_focal": "LossFocal", "loss_lovasz": "LossLovasz",
               "loss_focal_cam": "LossImageFocal", "loss_lovasz_cam": "LossImageLovasz",
               "loss_perception": "LossPerception", "entropy": "entropy",
               "entropy_cam": "ImageEntropy"}


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


def nuscenes_focal_alpha(nclasses: int) -> np.ndarray:
    """nuScenes' alpha: 1 for every class but class 0 (ignored)."""
    alpha = np.ones((nclasses,), np.float32)
    alpha[0] = 0.0
    return alpha


def sensat_focal_alpha(nclasses: int) -> np.ndarray:
    """SensatUrban's alpha: 1, class 0 (empty) at 0, the rare classes raised
    by hand (SENSAT_RARE_ALPHA)."""
    alpha = nuscenes_focal_alpha(nclasses)
    for cl, a in SENSAT_RARE_ALPHA.items():
        if cl < nclasses:
            alpha[cl] = a
    return alpha


class Trainer:
    """`model` (a PMFNet, EPMFNet or SalsaNext on `device`) trained on
    `n_train` samples of `train_reader` and validated on `n_val` samples of
    `val_reader`, with focal weights `alpha` [C] (classes of weight 0 are
    left out of the IoU). With `use_mtloss` in the config the six loss terms
    of a fusion net are weighted by `mt_sigma`, trained with the lidar
    stream. Random draws (the train view, dropout) come from one generator
    on the device, seeded by opts.seed (the same on every process, each
    keeping its rows of the global batch's draws). `recorder` takes the
    scalars and image panels. A `mesh` (`parallel.make_mesh`) of model size
    > 1 splits each sample's rows over its model group."""

    def __init__(self, opts, model, train_reader: Callable[[int], dict], n_train: int,
                 val_reader: Callable[[int], dict], n_val: int, device: torch.device,
                 alpha, class_names: dict | None = None, recorder=None, mesh=None):
        self.opts, self.model, self.device, self.recorder = opts, model, device, recorder
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        rank, size = (self.mesh.data_index, self.mesh.data) if self.mesh else world()
        self.loaders = {
            "Train": HostLoader(train_reader, n_train, opts.batch_size[0], shuffle=True,
                                drop_last=True, seed=opts.seed, num_workers=opts.n_threads,
                                process_index=rank, process_count=size),
            "Validation": HostLoader(val_reader, n_val, opts.batch_size[1], shuffle=False,
                                     drop_last=False, num_workers=opts.n_threads,
                                     process_index=rank, process_count=size)}
        broadcast_state(model)
        self.is_range = opts.net_type == "SalsaNext"
        self.is_sensat = opts.dataset == "SensatUrban"
        if self.is_range:
            self.view_cfg, self.view_keys = range_config(opts), _RANGE_KEYS
        elif self.is_sensat:
            self.view_cfg = {t: sensat_config(opts, t) for t in (True, False)}
            self.view_keys = _SENSAT_KEYS
        else:
            self.view_cfg = view_config(opts)
            pix = opts.dataset in A2D2_NAMES
            self.view_keys = _PIX_KEYS if pix else _VIEW_KEYS
            self.build = build_v2_batch_pix if pix else \
                build_v2_batch if opts.net_type == "EPMFNet" else build_batch
        self.class_names = class_names or {}
        self.point_lovasz = bool(opts.config.get("point_lovasz", True)) and not \
            (self.is_range or self.is_sensat)
        use_mtloss = bool(opts.config.get("use_mtloss")) and not self.is_range
        self.mt_sigma = torch.nn.Parameter(init_multi_task_params(6, device)) \
            if use_mtloss else None
        steps_per_epoch = max(self.n_batches("Train"), 1)
        self.lr_schedule = warmup_cosine_lr(
            opts.lr, opts.warmup_epochs * steps_per_epoch,
            (opts.n_epochs - opts.warmup_epochs) * steps_per_epoch)
        self.loss_cfg = LossConfig(nclasses=opts.nclasses, alpha=tuple(float(a) for a in alpha),
                                   lambda_=opts.lambda_, gamma=opts.gamma, tau=opts.tau,
                                   use_mtloss=use_mtloss, use_dice=self.is_sensat)
        if self.is_range:
            self.optimizer = adamw(model, self.lr_schedule)
            self.train_step = make_salsanext_train_step(model, self.optimizer, self.loss_cfg)
            self.eval_step = make_salsanext_eval_step(model, self.loss_cfg)
        else:
            self.optimizer = HybridOptimizer(model, self.lr_schedule, opts.momentum,
                                             opts.weight_decay,
                                             extra=[self.mt_sigma] if use_mtloss else [],
                                             amsgrad=self.is_sensat)
            self.train_step = make_pmf_train_step(model, self.optimizer, self.loss_cfg,
                                                  self.mt_sigma,
                                                  remat=bool(opts.config.get("remat")))
            self.eval_step = make_pmf_eval_step(model, self.loss_cfg, self.mt_sigma)
        ignore = [cl for cl, a in enumerate(alpha) if a == 0]
        self.metrics = IOUEval(opts.nclasses, ignore=ignore)
        self.metrics_img = IOUEval(opts.nclasses, ignore=ignore)
        self.remain_time = RemainTime(opts.n_epochs)
        self.generator = torch.Generator(device=device).manual_seed(opts.seed)
        self._panel_batch = None

    @classmethod
    def from_files(cls, opts, model, device: torch.device, recorder=None,
                   mesh=None) -> "Trainer":
        """The dataset under opts.data_root. SemanticKITTI: sequences 00-07,
        09, 10 to train on, 08 to validate on (SalsaNext reads no images);
        alpha from the config's `cls_freq`, or from the class-map YAML's
        content frequencies. nuScenes: the train and val scenes of the DB
        `nusc_version` (v1.0-mini under --debug, `is_debug`), split by
        `nusc_splits_file` or the official split, one item per (lidar,
        camera) pair for every net (SalsaNext reads only the scans); alpha
        1 for every class but class 0. A2D2 (`a2d2` or `A2D2`): the train and
        valid splits of `A2D2_PV` (`cams_lidars_json`, `class_index_json`,
        `apply_excludes`), the train split validating when the valid one is
        empty; alpha from the config's `cls_freq`. SensatUrban: the train
        frames, indexed by `sensat_frame_weights`, each read as a random
        window drawn from a RandomState seeded by opts.seed, and the val
        frames tiled at proj_h x proj_w; alpha `sensat_focal_alpha`, the
        class names shifted by one (0: ignore). `recorder` and `mesh` as in
        Trainer."""
        is_range = opts.net_type == "SalsaNext"
        if opts.dataset == "SensatUrban":
            trainset = SensatUrban(opts.data_root, "train")
            val_cfg = sensat_config(opts, False)
            valset = SensatUrban(opts.data_root, "val", img_h=val_cfg.img_h,
                                 img_w=val_cfg.img_w, use_crop=True)
            weights = sensat_frame_weights(
                trainset, int(opts.group("sensor").get("n_samples_split", 200)))
            names = {k + 1: v for k, v in trainset.mapped_cls_name.items() if k >= 0}
            names[0] = "ignore"
            return cls(opts, model,
                       sensat_sample_reader(trainset, sensat_config(opts, True), weights,
                                            rng=np.random.RandomState(opts.seed)),
                       len(weights), sensat_sample_reader(valset, val_cfg, train=False),
                       len(valset), device, sensat_focal_alpha(opts.nclasses), names, recorder,
                       mesh)
        if opts.dataset == "SemanticKitti":
            trainset = SemanticKitti(opts.data_root, TRAIN_SEQUENCES, has_image=not is_range)
            valset = SemanticKitti(opts.data_root, VAL_SEQUENCES, has_image=not is_range)
            if opts.config.get("cls_freq"):
                alpha = config_focal_alpha(opts.config["cls_freq"])
            else:
                alpha = kitti_focal_alpha(trainset.cls_freq, trainset.learning_ignore)
            view_reader = kitti_sample_reader
        elif opts.dataset == "nuScenes":
            version = "v1.0-mini" if opts.is_debug else \
                opts.config.get("nusc_version", "v1.0-trainval")
            trainset, valset = (Nuscenes(opts.data_root, version=version, split=split,
                                         splits_file=opts.config.get("nusc_splits_file"))
                                for split in ("train", "val"))
            alpha = nuscenes_focal_alpha(opts.nclasses)
            view_reader = nuscenes_sample_reader
        elif opts.dataset in A2D2_NAMES:
            paths = [opts.config.get(key, os.path.join(opts.data_root, name)) for key, name in
                     (("cams_lidars_json", "cams_lidars.json"),
                      ("class_index_json", "class_index.json"))]
            excludes = bool(opts.config.get("apply_excludes", True))
            trainset, valset = (A2D2_PV(opts.data_root, *paths, split=split,
                                        apply_excludes=excludes)
                                for split in ("train", "valid"))
            if len(valset) == 0:    # a set smaller than the train split's fixed end
                valset = trainset
            alpha = config_focal_alpha(opts.config["cls_freq"])
            view_reader = a2d2_sample_reader
        else:
            raise NotImplementedError(f"dataset {opts.dataset} is not ported yet")
        if is_range:
            reader, cfg = range_sample_reader, range_config(opts)
        else:
            reader, cfg = view_reader, view_config(opts)
        return cls(opts, model, reader(trainset, cfg), len(trainset), reader(valset, cfg),
                   len(valset), device, alpha, trainset.mapped_cls_name, recorder, mesh)

    def n_batches(self, mode: str) -> int:
        """The steps of a `mode` epoch, the same on every process."""
        loader = self.loaders[mode]
        size, bs = loader.process_count, loader.batch_size
        if mode == "Train":
            return loader.n_samples // size // bs
        return -(-(-(-loader.n_samples // size)) // bs)

    def _n_real(self, mode: str, b: int) -> int:
        """The samples of global batch b that are not padding."""
        loader = self.loaders[mode]
        bs = loader.batch_size
        return sum(min(max(len(range(r, loader.n_samples, loader.process_count)) - b * bs, 0), bs)
                   for r in range(loader.process_count))

    def batches(self, mode: str, epoch: int):
        """This process's `n_batches(mode)` batches of the epoch (the train
        shuffle of `epoch`). Past the end of its shard it gives all-invalid
        copies of its last batch (`batch_valid` all False)."""
        loader = self.loaders[mode]
        loader.set_epoch(epoch)
        it = iter(loader)
        last = None
        try:
            for _ in range(self.n_batches(mode)):
                batch = next(it, None)
                if batch is None:
                    if last is None:
                        sample = loader.reader(0)
                        last = {k: np.stack([v] * loader.batch_size) for k, v in sample.items()}
                    batch = {**last, "batch_valid": np.zeros(loader.batch_size, bool)}
                last = batch
                yield batch
        finally:
            it.close()

    def view(self, t: dict, train: bool):
        """The train or eval view of a batch of device tensors `t` (by the
        readers' keys): (feature, label, points), where points are the
        winner flags of the point-domain Lovász or None."""
        with torch.no_grad():
            if self.is_range:
                feature, label, _ = build_range_batch(t["points"], t["labels"], t["valid"],
                                                      self.view_cfg, train, self.generator)
                return feature, label, None
            if self.is_sensat:
                feature, label = build_sensat_batch(t["feature_map"], t["label_map"],
                                                    self.view_cfg[train], train, self.generator)
                return feature, label, None
            feature, _, label, *points = self.build(
                *(t[k] for k in self.view_keys), self.view_cfg, train, self.generator,
                return_points=self.point_lovasz)
        return feature, label, points[0] if points else None

    def _step(self, batch: dict, train: bool) -> dict:
        """The view and the step of one batch; under the mesh's row split
        the view is the data group's whole, the step this rank's rows of it
        (the points' winner flags stay whole)."""
        with self.mesh.split() if self.mesh else contextlib.nullcontext():
            feature, label, points = self.view(
                {k: torch.from_numpy(batch[k]).to(self.device) for k in self.view_keys}, train)
            self._panel_batch = (feature, label)
            feature, label = spatial.split_rows(feature), spatial.split_rows(label)
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
        stream's ImgAcc, ImgIOU, ImgRecall, the mean of each loss term, and
        the epoch's wall time over its Steps split into the seconds spent
        waiting for the loader's batches (DataTime) and the rest
        (StepTime). DT in the log lines is that wait alone. With the
        config's `profile_dir`, train iterations 2-4 of epoch 0 (each under
        the label "Train iteration {i}", a span of `utils/spans.py` as the
        port's own are) are traced into it (`_profiler`), as pmf_tpu's
        trainer traces them with jax.profiler."""
        train = mode == "Train"
        self.metrics.reset()
        self.metrics_img.reset()
        loss_meter, aux_meters = AverageMeter(), {}
        total_iter = self.n_batches(mode)
        pending: list = []
        loss = float("nan")
        data_s, steps = 0.0, 0
        profile_dir = self.opts.config.get("profile_dir") if train and epoch == 0 else None
        t_start = t_epoch = time.time()
        with contextlib.ExitStack() as trace:
            for i, batch in enumerate(self.batches(mode, epoch)):
                if profile_dir and i == 2:
                    trace.enter_context(self._profiler(profile_dir))
                t_proc = time.time()
                with span(f"{mode} iteration {i}"):
                    pending.append((self._step(batch, train), self._n_real(mode, i)))
                data_t, proc_t = t_proc - t_start, time.time() - t_proc
                data_s, steps = data_s + data_t, steps + 1
                self.remain_time.update(data_t + proc_t, mode)
                if i % 10 == 0 or i == total_iter - 1:
                    loss = self._drain(pending, loss_meter, aux_meters)
                    rt = datetime.timedelta(seconds=int(
                        self.remain_time.getRemainTime(epoch, i, total_iter, mode)))
                    line = (f">>> {mode} E[{self.opts.n_epochs:03d}|{epoch + 1:03d}] "
                            f"I[{total_iter:04d}|{i + 1:04d}] DT[{data_t:.3f}] PT[{proc_t:.3f}] "
                            f"LR {self.optimizer.lr:.5f} Loss {loss:.4f} "
                            f"Acc {self.metrics.getAcc()[0]:.4f} "
                            f"IOU {self.metrics.getIoU()[0]:.4f} "
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
                if i == 4:
                    trace.close()
                if self.opts.is_debug:
                    break
                t_start = time.time()
        self._drain(pending, loss_meter, aux_meters)
        wall = time.time() - t_epoch
        out = {"Acc": float(self.metrics.getAcc()[0]), "IOU": float(self.metrics.getIoU()[0]),
               "Recall": float(self.metrics.getRecall()[0]), "last": 0.0}
        if not self.is_range:
            out.update(ImgAcc=float(self.metrics_img.getAcc()[0]),
                       ImgIOU=float(self.metrics_img.getIoU()[0]),
                       ImgRecall=float(self.metrics_img.getRecall()[0]))
        out.update(Loss=loss_meter.avg, **{k: m.avg for k, m in aux_meters.items()})
        if self.recorder is not None:
            self._record_scalars(mode, epoch, loss_meter.avg, aux_meters)
            self._log_image_panels(mode, epoch)
        out.update(DataTime=data_s, StepTime=wall - data_s, Steps=steps)
        log.info(f"{mode} epoch {epoch}: " + " ".join(f"{k} {v:.4f}" for k, v in out.items()))
        return out

    def _profiler(self, profile_dir: str):
        """torch.profiler over the host and, on the card, its kernels, whose
        trace goes to `profile_dir` as `{rank}.{time}.pt.trace.json`, which
        TensorBoard's profiler plugin reads."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(
            profile_dir, worker_name=str(world()[0])))

    def _record_scalars(self, mode: str, epoch: int, loss: float, aux_meters: dict):
        """The epoch's means under pmf_tpu's tags: {mode}_{Loss, meanAcc,
        meanIOU, meanRecall, lr}, each loss term's (SCALAR_TAGS), the
        per-class {mode}_{c:02d}_{name}_{Acc, Recall, IOU}, and for the
        fusion nets the image stream's {mode}_Image_mean* and per-class
        {mode}_{c:02d}_{name}_Image{Acc, Recall, IOU}."""
        rec = self.recorder
        streams = [(self.metrics, "", "")]
        if not self.is_range:
            streams.append((self.metrics_img, "Image_", "Image"))
        for metrics, mean_prefix, cls_prefix in streams:
            (macc, acc), (miou, iou), (mrec, rec_c) = (metrics.getAcc(), metrics.getIoU(),
                                                     metrics.getRecall())
            if not mean_prefix:
                for tag, v in (("Loss", loss), ("meanAcc", macc), ("meanIOU", miou),
                               ("meanRecall", mrec), ("lr", self.optimizer.lr)):
                    rec.add_scalar(f"{mode}_{tag}", v, epoch)
                for k, m in aux_meters.items():
                    rec.add_scalar(f"{mode}_{SCALAR_TAGS.get(k, k)}", m.avg, epoch)
            else:
                for tag, v in (("meanAcc", macc), ("meanIOU", miou), ("meanRecall", mrec)):
                    rec.add_scalar(f"{mode}_{mean_prefix}{tag}", v, epoch)
            for c, name in self.class_names.items():
                c = int(c)
                if c < len(iou):
                    for metric, vals in (("Acc", acc), ("Recall", rec_c), ("IOU", iou)):
                        rec.add_scalar(f"{mode}_{c:02d}_{name}_{cls_prefix}{metric}",
                                       float(vals[c]), epoch)

    @torch.no_grad()
    def _log_image_panels(self, mode: str, epoch: int):
        """pmf_tpu's image panels of the last batch's first sample, every
        print_frequency epochs, for the fusion nets, not on nuScenes: the
        lidar channels and the RGB, each class's probability in both streams
        and its label mask, both streams' entropy and the perception-aware
        guide weights."""
        opts = self.opts
        if (self.is_range or not bool(opts.config.get("log_images", True))
                or epoch % opts.print_frequency != 0 or opts.dataset == "nuScenes"
                or self._panel_batch is None):
            return
        feature, label = self._panel_batch
        self.model.eval()
        lidar, cam = self.model(feature[:1, ..., :5], feature[:1, ..., 5:8])
        lidar, cam = lidar[0].float().cpu().numpy(), cam[0].float().cpu().numpy()
        f0 = feature[0].float().cpu().numpy()
        lab = label[0].cpu().numpy()
        rec = self.recorder
        for c in range(f0.shape[-1] - 3):
            rec.add_image(f"{mode}_PCDFeature_{c}", f0[..., c], epoch)
        rec.add_image(f"{mode}_RGB", f0[..., -3:], epoch)
        for c, name in self.class_names.items():
            c = int(c)
            if c < lidar.shape[-1]:
                rec.add_image(f"{mode}_Pred_cls_{c:02d}_{name}", lidar[..., c], epoch)
                rec.add_image(f"{mode}_RGBPred_cls_{c:02d}_{name}", cam[..., c], epoch)
                rec.add_image(f"{mode}_Label_cls_{c:02d}_{name}", (lab == c).astype(np.float32),
                              epoch)
        nc = lidar.shape[-1]
        ent_pcd = -(lidar * np.log(np.clip(lidar, 1e-8, None))).sum(-1) / np.log(nc)
        ent_img = -(cam * np.log(np.clip(cam, 1e-8, None))).sum(-1) / np.log(nc)
        imp = (1.0 - ent_pcd) - (1.0 - ent_img)
        rec.add_image(f"{mode}_PredEntropy", ent_pcd, epoch)
        rec.add_image(f"{mode}_RGBPredEntropy", ent_img, epoch)
        rec.add_image(f"{mode}_PCDGuideWeight",
                      (imp > 0) * np.abs(imp) * (1.0 - ent_pcd >= opts.tau), epoch)
        rec.add_image(f"{mode}_RGBGuideWeight",
                      (imp < 0) * np.abs(imp) * (1.0 - ent_img >= opts.tau), epoch)
