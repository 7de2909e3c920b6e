"""The port's benchmark (counterpart of `bench.py`): PMF-ResNet34 on
SemanticKITTI, eval and train, on one NVIDIA card.

    python -m pmf_tpu_torch.tools.bench [--cell NAME|all | --phase PHASE ...]
        [--seed 0] [--iters N] [--repeats 5] [--device cuda|cpu]

Phases, with `bench.py`'s shapes and metric names (random weights from
`models.random_weights(seed)`, synthetic scans from
`data/synthetic.py: make_inputs`, whose pinhole camera lands the points in
the image; bf16 compute, 20 classes, base 32, ResNet34):

  eval        cell pmf_r34_kitti_eval_b8: build_batch (eval view, K2) →
              PMFNet → argmax_last, batch 8, 384x1232, 32768 points a scan;
  train       cell pmf_r34_kitti_train_b8: build_batch in train mode with
              return_points (flip, rotation, 256x1024 crop, ColorJitter 0.4;
              K2, then K1 through point_winner_flags) → make_pmf_train_step
              (focal and Lovász on both streams, the perception-aware KL,
              point Lovász) → HybridOptimizer, batch 8, the draws from a
              generator seeded by --seed;
  epmf        EPMF-ResNet34 eval (build_v2_batch, K2 with 64-bit keys),
              batch 8, 320x1280, 131072 points a scan;
  epmf_train  the EPMF train step of epmf_kitti.yaml (multi-task loss,
              image-domain Lovász; K2), batch 2, 320x1280, 131072 points.

`--cell all` (the default) runs the two cells; `--phase` runs phases by name.

Each phase prints one JSON line. On the card: the scans/s of the timed
window (`value`, the median over `repeats` runs of `iters` calls each, and
`spread`, their max − min over the median; the inputs sit on the device
before it opens, it ends in torch.cuda.synchronize() and reads nothing back
inside); the FLOPs a scan (`utils/flops.py: count_flops`, pmf_tpu's count,
run outside the window, for train on a copy of the model and optimizer) and
the MFU against the H100's bf16 peak; the peak device memory of the window;
the occupied share of the view's canvas; the host's waits a call; the
per-layer split of one call (CUDA events, a second window); each kernel's
launches a call and its device time at the phase's view (a replayed CUDA
graph; K1 on the view's packed keys where the call does not run it), its
bound (`utils/timing.py`) and its bound share; a torch.profiler window (the
device's idle share and the operations whose kernels took the most device
time); the card's name and power limit (nvidia-smi). With `--device cpu` (a
rehearsal at any size) every time, rate, memory and share of device time
reads null and the device reads "cpu"; the counts (FLOPs, bytes, launches)
and the gates are computed.

The gates run untimed, after the windows, and a failed gate prints its
numbers beside their limits and exits 1. The reference runs the kernels'
plain twins (`ops/rasterize.py: rasterize_zbuffer_plain`,
`ops/zbuffer.py: zbuffer_keys_plain`) and the model in float32 with TF32 off:

  eval   the view through the kernels equals the plain view bit for bit
         (features, mask, labels); the bf16 predictions equal the float32
         forward's argmax on at least `agree_min` of the occupied pixels;
  train  from the same generator state, the step's view equals the plain
         view bit for bit (features, mask, labels and the points' pixel,
         label and winner flag); the bf16 step's loss is within `loss_rtol` of
         the float32 forward's on the plain view, and its gradients' cosine
         with the float32 gradients is at least `grad_cos_min`;
  both   the canvas's occupied share is at least `occupied_min` (the phase's limits).
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..data import PVConfig, V2Config, build_batch, build_v2_batch
from ..data.perspective_pipeline import (_affine_params, _build_batch, augmented_points,
                                         view_geometry)
from ..data.perspective_pipeline_v2 import _build_v2_batch, v2_view_geometry
from ..data.synthetic import make_inputs
from ..losses import init_multi_task_params
from ..models import EPMFNet, PMFNet, random_weights
from ..ops import argmax_last, kernels, rasterize, zbuffer
from ..ops.scatter import packed_keys
from ..parallel import average_gradients
from ..train import HybridOptimizer, LossConfig, make_pmf_train_step, pmf_losses, warmup_cosine_lr
from ..train.steps import global_confusion
from ..utils import H100_BF16_PEAK_FLOPS, count_flops, disable_tf32, mfu, resolve_device
from ..utils.timing import bound_ms, card_name, device_ms, keys_bytes, rasterize_bytes

NCLASSES = 20
WARMUP = 3          # calls before the timed window: cuDNN's choice at each shape, the allocator
SPLIT_REPEATS = 5   # calls split by CUDA events; the median of each part
PROFILE_ITERS = 2   # calls in the torch.profiler window
TOP_OPS = 10
STREAMS = ("camera_stream_encoder", "camera_stream_decoder", "lidar_stream")
KERNELS = ("rasterize", "zbuffer_keys")  # K2, and K1 as the per-scan views and winner flags run it


@dataclass(frozen=True)
class Phase:
    name: str                   # eval | train | epmf | epmf_train
    cell: str | None            # the cell it measures, or None
    metric: str
    net: str                    # PMFNet | EPMFNet
    train: bool
    batch: int
    points: int
    image: tuple[int, int]      # the scans' image (make_inputs' h, w)
    view: tuple[int, int]       # the eval view, or the train crop
    iters: int                  # timed calls a repeat
    base_channels: int = 32
    # the gates' limits: the worst value measured on the card (seeds 0 and 1
    # and the state after a short run) with a margin of about 2x (PERF.md §2)
    agree_min: float = 0.97     # bf16 argmax == float32 argmax, share of occupied pixels
    loss_rtol: float = 1e-3     # |loss_bf16 - loss_f32| / |loss_f32|
    grad_cos_min: float = 0.8   # cosine of all the bf16 step's gradients with the float32 ones
    occupied_min: float = 0.02  # occupied share of the view's canvas

    @property
    def point_lovasz(self) -> bool:
        """PMF trains with the point-domain Lovász (K1's winner flags); EPMF
        in the image domain (epmf_kitti.yaml's `point_lovasz: false`)."""
        return self.train and self.net == "PMFNet"

    @property
    def flops_key(self) -> str:
        return "flops_per_scan" if self.name == "eval" else f"{self.name}_flops_per_scan"

    @property
    def on_path(self) -> tuple[str, ...]:
        """The kernels that the timed call launches: K2 in every view, K1
        for the point Lovász's winner flags."""
        return ("rasterize", "zbuffer_keys") if self.point_lovasz else ("rasterize",)

    def fields(self) -> tuple[str, ...]:
        """The keys of this phase's line."""
        split = ("view_ms", "forward_ms", "loss_ms", "backward_ms", "optimizer_ms",
                 "confusion_ms") if self.train else ("view_ms", "model_ms", "argmax_ms")
        per_kernel = tuple(f"{k}_{x}" for k in KERNELS for x in (
            "device_ms", "bound_ms", "bound_by", "bound_share", "bytes", "launches"))
        return ("cell", "phase", "metric", "unit", "value", "spread", "runs", "iters", "repeats",
                "batch", "points", "view", "dtype", "seed", "setup_s", "warmup_s", "flops",
                self.flops_key, f"mfu_{self.name}", f"{self.name}_peak_mem_gib",
                "occupied_px_share", "syncs_per_call", *split, *per_kernel, "idle_share",
                "busy_ms", "wall_ms", "top_ops", "profiler", "gates", "device", "card")


IMAGE = (384, 1232)      # bench.py:66, pmf_kitti.yaml's eval view
PHASES = {p.name: p for p in (
    Phase("eval", "pmf_r34_kitti_eval_b8", "pmf_r34_kitti_eval_scans_per_sec_per_chip",
          "PMFNet", False, 8, 32768, IMAGE, IMAGE, iters=10),
    # 10 steps a run: at 5, runs of one tree in turns spread 2-3 % between
    # their quartiles (the step waits on the host about 23 times)
    Phase("train", "pmf_r34_kitti_train_b8", "pmf_r34_kitti_train_scans_per_sec_per_chip",
          "PMFNet", True, 8, 32768, IMAGE, (256, 1024), iters=10),
    Phase("epmf", None, "epmf_r34_kitti_eval_scans_per_sec_per_chip",
          "EPMFNet", False, 8, 131072, IMAGE, (320, 1280), iters=10),
    # the EPMF train crop lands anywhere in the kept points' box, which on
    # these scans is about 1440 px tall (points from 2 m): its occupied share
    # runs from 3e-4 to 0.13 by the draw, and the float32 comparison is
    # looser on a near-empty crop
    Phase("epmf_train", None, "epmf_r34_kitti_train_scans_per_sec_per_chip",
          "EPMFNet", True, 2, 131072, IMAGE, (320, 1280), iters=5, loss_rtol=1e-2,
          grad_cos_min=0.5, occupied_min=1e-4),
)}


class GateFailed(Exception):
    pass


def view_config(phase: Phase):
    """pmf_kitti.yaml's `sensor` group (bench.py's PVConfig) or
    epmf_kitti.yaml's `PVconfig`, at the phase's sizes; ColorJitter 0.4."""
    (ih, iw), (vh, vw) = phase.image, phase.view
    jitter = (0.4, 0.4, 0.4)
    if phase.net == "PMFNet":
        eh, ew = phase.image if phase.train else phase.view
        return PVConfig(canvas_h=ih, canvas_w=iw + 16, proj_h=eh, proj_w=ew, proj_ht=vh,
                        proj_wt=vw, h_pad=7, w_pad=3, n_points=phase.points, img_jitter=jitter)
    return V2Config(canvas_h=ih, canvas_w=iw + 16, proj_h=vh, proj_w=vw, proj_ht=vh, proj_wt=vw,
                    n_points=phase.points, img_jitter=jitter)


def make_batch(phase: Phase, seed: int, dev) -> list[torch.Tensor]:
    """The phase's scans from `seed` (points, labels, valid, proj, image,
    img_h, img_w), on `dev`."""
    raw = make_inputs(np.random.default_rng(seed), phase.batch, phase.points, *phase.image)
    return [torch.from_numpy(a).to(dev) for a in raw]


def make_model(phase: Phase, seed: int, dev):
    """The phase's net in bf16 with random weights from `seed`, on `dev`."""
    torch.manual_seed(seed)
    net = {"PMFNet": PMFNet, "EPMFNet": EPMFNet}[phase.net]
    return random_weights(net(nclasses=NCLASSES, base_channels=phase.base_channels,
                              image_backbone="resnet34", dtype=torch.bfloat16), seed).to(dev)


def loss_config(phase: Phase) -> LossConfig:
    """bench.py's: class 0 ignored; EPMF with epmf_kitti.yaml's multi-task loss."""
    return LossConfig(nclasses=NCLASSES, alpha=(0.0,) + (1.0,) * (NCLASSES - 1),
                      use_mtloss=phase.net == "EPMFNet")


def make_optimizer(model, sigma):
    """bench.py's: warm-up cosine from 1e-3 over 100 of 10000 steps,
    momentum 0.9, weight decay 1e-5; σ of the multi-task loss in AdamW."""
    return HybridOptimizer(model, warmup_cosine_lr(1e-3, 100, 10000), 0.9, 1e-5,
                           extra=[] if sigma is None else [sigma])


def view(phase: Phase, cfg, batch, generator=None, plain: bool = False):
    """The phase's view of `batch`: through the kernels, as the users' entry
    points build it, or (`plain`) through their plain twins. (feature, mask,
    label[, points])."""
    if plain:
        build = _build_batch if phase.net == "PMFNet" else _build_v2_batch
        return build(*batch, cfg, phase.train, generator, None, phase.point_lovasz,
                     fill=rasterize.rasterize_zbuffer_plain, keys=zbuffer.zbuffer_keys_plain)
    if phase.net == "PMFNet":
        return build_batch(*batch, cfg, phase.train, generator,
                           return_points=phase.point_lovasz)
    return build_v2_batch(*batch, cfg, phase.train, generator)


def geometry(phase: Phase, cfg, batch, generator):
    """(rows, cols, depth, keep, values) that the phase's view gives K2, with
    the train view's parameters drawn from `generator`."""
    if phase.net == "PMFNet":
        aug = None
        points = batch[0]
        if phase.train:
            aug = _affine_params(generator, batch[5], batch[6], cfg)
            points = augmented_points(points, cfg, aug.points)
        rows, cols, keep, depth, vals, _ = view_geometry(points, *batch[1:], cfg, aug)
    else:
        rows, cols, keep, depth, vals, _ = v2_view_geometry(*batch, cfg, phase.train, generator)
    return rows, cols, depth, keep, vals.contiguous()


class Run:
    """One phase's model, optimizer, generator and inputs on `dev`, and its
    timed call (`call`)."""

    def __init__(self, phase: Phase, seed: int, dev):
        self.phase, self.dev = phase, dev
        self.cfg = view_config(phase)
        self.batch = make_batch(phase, seed, dev)
        self.model = make_model(phase, seed, dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.loss_cfg = loss_config(phase)
        self.sigma = torch.nn.Parameter(init_multi_task_params(6, dev)) \
            if self.loss_cfg.use_mtloss else None
        if phase.train:
            self.optimizer = make_optimizer(self.model, self.sigma)
            self.step = make_pmf_train_step(self.model, self.optimizer, self.loss_cfg, self.sigma)

    def clone_generator(self) -> torch.Generator:
        """A generator in this run's generator's state."""
        return torch.Generator(device=self.dev).set_state(self.generator.get_state())

    def call(self):
        """One timed call: the eval batch's predictions, or one train step's
        aux (not read)."""
        if not self.phase.train:
            with torch.inference_mode():
                f, _, _ = view(self.phase, self.cfg, self.batch)
                lidar, _ = self.model(f[..., :5], f[..., 5:8])
                return argmax_last(lidar)
        with torch.no_grad():
            f, _, lab, *points = view(self.phase, self.cfg, self.batch, self.generator)
        return self.step(f, lab, self.generator, points[0] if points else None)

    def split(self) -> dict:
        """One call's parts, timed by CUDA events (the step's own pieces, in
        its order); the median of SPLIT_REPEATS calls."""
        phase, model = self.phase, self.model
        runs = []
        for _ in range(SPLIT_REPEATS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7 if phase.train else 4)]
            ev[0].record()
            if not phase.train:
                with torch.inference_mode():
                    f, _, _ = view(phase, self.cfg, self.batch)
                    ev[1].record()
                    lidar, _ = model(f[..., :5], f[..., 5:8])
                    ev[2].record()
                    argmax_last(lidar)
                    ev[3].record()
            else:
                with torch.no_grad():
                    f, _, lab, *points = view(phase, self.cfg, self.batch, self.generator)
                ev[1].record()
                model.train()
                self.optimizer.zero_grad()
                lidar, cam = model(f[..., :5], f[..., 5:8], self.generator)
                ev[2].record()
                total, _ = pmf_losses(lidar, cam, lab, self.loss_cfg,
                                      points[0] if points else None, self.sigma)
                ev[3].record()
                total.backward()
                average_gradients(model.parameters())
                ev[4].record()
                self.optimizer.step()
                ev[5].record()
                with torch.no_grad():
                    for p in (lidar, cam):
                        global_confusion(p, lab, NCLASSES)
                ev[6].record()
            torch.cuda.synchronize()
            runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)])
        names = ("view_ms", "forward_ms", "loss_ms", "backward_ms", "optimizer_ms",
                 "confusion_ms") if phase.train else ("view_ms", "model_ms", "argmax_ms")
        return {n: statistics.median(c) for n, c in zip(names, zip(*runs))}

    def kernel_numbers(self) -> dict:
        """Each kernel at the phase's view geometry (K1 on its packed keys,
        as the per-scan views and the winner flags give them, whether or not
        the timed call runs it): its device time (a replayed CUDA graph), the
        bytes it must move, its bound and bound share. Times are None off
        the card."""
        phase, on_card = self.phase, self.dev.type == "cuda"
        h, w = phase.view
        rows, cols, depth, keep, vals = geometry(phase, self.cfg, self.batch,
                                                 self.clone_generator())
        out = {}
        pix, key, _ = packed_keys(rows, cols, depth, keep, h, w, 1 / 64)
        pix, key = pix.contiguous(), key.contiguous()
        calls = {"rasterize": lambda: rasterize.rasterize_zbuffer(rows, cols, depth, keep, vals,
                                                                  h, w),
                 "zbuffer_keys": lambda: zbuffer.zbuffer_keys(pix, key, h, w)}
        counts = {"rasterize": rasterize_bytes(keep, vals.shape[-1], h, w),
                  "zbuffer_keys": keys_bytes(pix, int(keep.sum()), h, w)}
        for k, fn in calls.items():
            n_bytes, n_ops = counts[k]
            bound, by = bound_ms(n_bytes, n_ops)
            dms = device_ms(fn) if on_card else None
            out.update({f"{k}_device_ms": dms, f"{k}_bound_ms": bound if on_card else None,
                        f"{k}_bound_by": by, f"{k}_bound_share": bound / dms if dms else None,
                        f"{k}_bytes": n_bytes})
        return out


def launch_counts() -> dict:
    return {"rasterize": rasterize.rasterize_zbuffer.launches,
            "zbuffer_keys": zbuffer.zbuffer_keys.launches}


def timed_window(run: Run, iters: int, repeats: int) -> list[float]:
    """scans/s of each of `repeats` runs of `iters` calls: host clock from
    a synchronized card to torch.cuda.synchronize() after the last call."""
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run.call()
        torch.cuda.synchronize()
        rates.append(run.phase.batch * iters / (time.perf_counter() - t0))
    return rates


def syncs_per_call(run: Run) -> int:
    """The host's waits for the card in one call (torch's sync debug mode
    warns at each operation that synchronizes: a read-back, a
    data-dependent shape)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run.call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_window(run: Run) -> dict:
    """torch.profiler over PROFILE_ITERS calls: the device's busy time
    against the window's wall time (the profiler's own cost included), and
    the TOP_OPS operations whose kernels took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_ITERS):
            run.call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILE_ITERS
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3 / PROFILE_ITERS
    if busy == 0:
        return {"idle_share": None, "busy_ms": None, "wall_ms": wall, "top_ops": None,
                "profiler": "the trace holds no device time; the CUDA-event split stands"}
    ops = sorted(((e.self_device_time_total / 1e3 / PROFILE_ITERS, e.count // PROFILE_ITERS,
                   e.key) for e in events
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 reverse=True)[:TOP_OPS]
    return {"idle_share": 1 - busy / wall, "busy_ms": busy, "wall_ms": wall,
            "top_ops": [{"op": k, "ms": t, "calls": n} for t, n, k in ops],
            "profiler": "torch.profiler"}


def train_copy(run: Run) -> Run:
    """A train run that shares nothing the timed one updates: its model and
    σ deep-copied, a fresh optimizer and step over them, a clone of its
    generator in the same state."""
    c = copy.copy(run)
    c.model, c.sigma = copy.deepcopy((run.model, run.sigma))
    c.optimizer = make_optimizer(c.model, c.sigma)
    c.step = make_pmf_train_step(c.model, c.optimizer, run.loss_cfg, c.sigma)
    c.generator = run.clone_generator()
    return c


def count_call_flops(run: Run) -> int:
    """The FLOPs of one call; a train step is counted on a `train_copy`."""
    return count_flops((train_copy(run) if run.phase.train else run).call)


def float32_copy(model):
    m = copy.deepcopy(model)
    m.dtype = torch.float32
    return m


def points_of(out):
    """The points' (pixel, label, winner flag) of a view, or None."""
    return out[3] if len(out) > 3 else None


def view_differences(got, want) -> list[str]:
    """The names of the view's tensors that differ."""
    names = ("features", "mask", "labels", "pt_pix", "pt_label", "pt_won")
    got, want = [*got[:3], *(points_of(got) or ())], [*want[:3], *(points_of(want) or ())]
    return [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]


def trained(model, sigma) -> dict:
    """The parameters a train step updates, by name."""
    return dict(model.named_parameters(), **({} if sigma is None else {"mt_sigma": sigma}))


def gate_eval(run: Run) -> tuple[dict, bool]:
    """The eval gates: (their numbers beside their limits, whether one
    failed)."""
    phase = run.phase
    with torch.inference_mode():
        got = view(phase, run.cfg, run.batch)
        lidar, _ = run.model(got[0][..., :5], got[0][..., 5:8])
        pred = argmax_last(lidar)
        want = view(phase, run.cfg, run.batch, plain=True)
        ref = float32_copy(run.model)(want[0][..., :5], want[0][..., 5:8])[0].argmax(-1)
    occupied = want[1].float().mean().item()
    agree = (pred == ref)[want[1]].float().mean().item()
    gates = {"view_differs_in": view_differences(got, want), "agree": agree,
             "agree_min": phase.agree_min, "occupied": occupied,
             "occupied_min": phase.occupied_min}
    failed = (gates["view_differs_in"] or not agree >= phase.agree_min
              or not occupied >= phase.occupied_min)
    return gates, failed


def gate_train(run: Run) -> tuple[dict, bool]:
    """The train gates, from one generator state: the step's view against
    the plain view, and the bf16 step (on a copy of the model and σ, with a
    fresh optimizer) against a float32 forward and backward of the same
    weights on the plain view: (their numbers beside their limits, whether
    one failed)."""
    phase, g = run.phase, run.generator
    tested = train_copy(run)
    grads = {}

    def keep_grads(*_):     # the gradients as the first optimizer finds them
        grads.update({k: p.grad.double() for k, p in trained(tested.model, tested.sigma).items()
                      if p.grad is not None})

    hook = next(iter(tested.optimizer.optimizers.values())).register_step_pre_hook(keep_grads)
    with torch.no_grad():
        got = view(phase, run.cfg, run.batch, tested.generator)
    loss = tested.step(got[0], got[2], tested.generator, points_of(got))["loss"].item()
    hook.remove()
    del tested      # the card's memory for the float32 step

    with torch.no_grad():
        want = view(phase, run.cfg, run.batch, g, plain=True)
    ref, ref_sigma = float32_copy(run.model), copy.deepcopy(run.sigma)
    ref.train()
    lidar, cam = ref(want[0][..., :5], want[0][..., 5:8], g)
    total, _ = pmf_losses(lidar, cam, want[2], run.loss_cfg, points_of(want), ref_sigma)
    total.backward()
    ref_grads = {k: p.grad.double() for k, p in trained(ref, ref_sigma).items()
                 if p.grad is not None}

    def distance(prefix=""):
        keys = [k for k in ref_grads if k.startswith(prefix)]
        x = torch.cat([grads.get(k, torch.zeros_like(ref_grads[k])).flatten() for k in keys])
        y = torch.cat([ref_grads[k].flatten() for k in keys])
        return (x @ y / (x.norm() * y.norm())).item(), ((x - y).norm() / y.norm()).item()

    loss_ref = total.item()
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    cos, rel = distance()
    occupied = want[1].float().mean().item()
    gates = {"view_differs_in": view_differences(got, want), "loss": loss, "loss_ref": loss_ref,
             "loss_rel": loss_rel, "loss_rtol": phase.loss_rtol, "grad_cos": cos,
             "grad_cos_min": phase.grad_cos_min, "grad_rel": rel,
             "grad_cos_by_stream": {s: distance(s)[0] for s in STREAMS},
             "occupied": occupied, "occupied_min": phase.occupied_min}
    failed = (gates["view_differs_in"] or not loss_rel <= phase.loss_rtol
              or not cos >= phase.grad_cos_min or not occupied >= phase.occupied_min)
    return gates, failed


def run_phase(phase: Phase, seed: int, dev, iters: int | None = None, repeats: int = 5,
              card: str | None = None) -> dict:
    """Measure `phase` on `dev` and gate it: its line. Raises GateFailed."""
    on_card = dev.type == "cuda"
    iters = iters or phase.iters
    line = dict.fromkeys(phase.fields())
    line.update(cell=phase.cell, phase=phase.name, metric=phase.metric, unit="scans/s",
                iters=iters, repeats=repeats, batch=phase.batch, points=phase.points,
                view=list(phase.view), dtype="bfloat16", seed=seed, card=card,
                device=torch.cuda.get_device_name(dev) if on_card else "cpu")
    t0 = time.perf_counter()
    run = Run(phase, seed, dev)
    launches = dict.fromkeys(KERNELS, 0)
    if on_card:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(WARMUP):
            run.call()
        torch.cuda.synchronize()
        line.update(setup_s=t1 - t0, warmup_s=time.perf_counter() - t1)
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        rates = timed_window(run, iters, repeats)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {k: (launch_counts()[k] - before[k]) / (iters * repeats) for k in launches}
        if not all(launches[k] for k in phase.on_path):
            raise GateFailed(f"{phase.name}: a kernel of the path was not launched in the "
                             f"timed window: {launches}")
        med = statistics.median(rates)
        line.update(value=med, spread=(max(rates) - min(rates)) / med, runs=rates,
                    syncs_per_call=syncs_per_call(run), **{f"{phase.name}_peak_mem_gib": peak},
                    **run.split(), **profile_window(run))
    gates, failed = (gate_train if phase.train else gate_eval)(run)
    line.update(occupied_px_share=gates["occupied"], gates=gates)
    if failed:
        raise GateFailed(f"{phase.name}: {json.dumps(gates)}")
    line.update(run.kernel_numbers())
    line.update({f"{k}_launches": n for k, n in launches.items()})
    flops = count_call_flops(run)   # off the card, the one run of the phase's path
    line.update({"flops": flops, phase.flops_key: flops / phase.batch / 1e9})
    if on_card:
        line[f"mfu_{phase.name}"] = mfu(flops / phase.batch * line["value"], H100_BF16_PEAK_FLOPS)
    # numbers no card can give are faults of the measurement
    shares = [line[f"{k}_bound_share"] for k in KERNELS]
    if on_card and not (all(s <= 1 for s in shares) and line[f"mfu_{phase.name}"] < 1):
        raise GateFailed(f"{phase.name}: bound shares {shares} or MFU "
                         f"{line[f'mfu_{phase.name}']} above 1: a count or timing fault")
    return line


def main(argv=None, phases: dict | None = None) -> None:
    """The command line of the module's docstring; `phases` replaces PHASES
    (another size, for a rehearsal)."""
    phases = PHASES if phases is None else phases
    cells = {p.cell: p.name for p in phases.values() if p.cell}
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--cell", choices=[*cells, "all"], default="all")
    which.add_argument("--phase", nargs="+", choices=list(phases))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=None,
                        help="timed calls a repeat (default: the phase's own)")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    disable_tf32()
    names = args.phase or (list(cells.values()) if args.cell == "all" else [cells[args.cell]])
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bench: {e}")
    card = None
    if dev.type == "cuda":
        card = card_name()
        kernels.build()
        kernels.load()
    for name in names:
        try:
            line = run_phase(phases[name], args.seed, dev, args.iters, args.repeats, card)
        except GateFailed as e:
            raise SystemExit(f"bench: GATE FAILED: {e}")
        print(json.dumps(line), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
