"""Drive the PyTorch port (pmf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:
  1. device: the card's name and power limit (nvidia-smi), torch's version;
  2. build: compile the CUDA kernels from pmf_tpu_torch/csrc for sm_90a;
  3. kernels: each kernel on the eval path's own inputs (batch 8 of
     32768-point synthetic scans, 384x1232, 6 features), with forced ties,
     held to its plain PyTorch version exactly, and on the cases off that
     path: K2 with 64-bit keys (1 scan of 131072 points), at the key-width
     boundary (65535 and 65536 points), both kernels with every point on 64
     pixels and with every point dropped. Then times: the kernel
     host-inclusive (`ms`) and on the device alone (`device_ms`, a CUDA
     graph of 20 calls), its plain version and one PyTorch library call for
     the same function; and each kernel's per-pass split (torch.profiler);
     (b) ASPP's branch kernel (ops/aspp.py) at the four shapes the
     benchmark's nets give it (EPMF's camera decoder 8x512x20x80, PMF's
     lidar head 8x256x24x77 and 1x256x24x77, EPMF's 8x256x10x40), x
     channels-last as the nets hold it, held as in phase 15; timed as K1
     and K2, with cuDNN's four convs as the nets called them (`library_ms`)
     and on an NCHW copy (`library_nchw_ms`), and its bound (the products of
     the taps that reach the map at the bf16 peak). From here on every
     ASPP forward is watched (`AsppWatch`): it must launch the kernel once
     where ASPP.forward's conditions hold (CUDA bf16 x with C a multiple of
     128, grad off, no row split) and never elsewhere, and each shape and
     layout the kernel ran at is kept for phase 15; (c) the conv epilogue
     (ops/epilogue.py) in place at the ten shapes of the card test
     (tests/test_torch_cuda.py: EPILOGUE_SHAPES: PMF-KITTI's lidar stream at
     full resolution with 32 and 64 channels, a 256-channel 1/8 map, the
     20-class logits, the stem's relu, a fusion block's sigmoid, ResNet34's
     and ResNet50's layer4, a keyframe item's context block and 17-class
     logits at 896x1600), held to its plain twin on the same card tensors (1
     bf16 ulp; equal but for sigmoid) and timed as K1 and K2 over copies of
     its operands, so that each call reads past the L2, beside its bytes
     bound, the twin and PyTorch's chain of passes it replaced
     (`library_ms`). From here on every eval path below counts the conv
     epilogue's launches: one a conv in bf16 (105 a PMF-ResNet34 forward, 99
     EPMF-ResNet34, 122 PMF-ResNet50, 51 SalsaNext), none in float32; (d)
     the train-mode conv epilogue (ops/epilogue_train.py: batch-statistics
     BN, activation, residual) at the seven shapes of the card test
     (BN_TRAIN_SHAPES: the train cell's 64- and 32-channel full-resolution
     maps, ResNet34's stem and layer4, the first fusion block's attention, a
     downsample), forward and backward, held to its twin as the card test
     holds it and timed: the Function host-inclusive, its four passes in a
     CUDA graph, beside its bytes bound, the twin and PyTorch's chain. From
     here on every eval path must launch it none, every Trainer's step
     (`train_path`) four times a BN it takes in bf16 (376 PMF-ResNet34, 344
     EPMF-ResNet34) and none in float32, and a Trainer with a process
     group up (11(b)) none;
  4. reference: the port in float32 on the card against the port on the CPU
     (which the tests hold to pmf_tpu) at a small size, with random weights
     under which the probabilities depend on the input;
  5. main path: PMF-ResNet34 (20 classes, base 32, bf16 compute, random
     weights from a seed) on batched eval at full width, build_batch →
     PMFNet → argmax, then one scan through the Inference.run loop of
     tools/infer_kitti (per-scan view → forward → KNN lift → IoU). The
     kernels' launch counts are read around this phase alone, and both
     must be > 0; the ASPP kernel's around one batched call and around the
     scan, each of which must be 1 (its lidar head; 2 for EPMF in 7(c):
     `launches_aspp`), and the conv epilogue's likewise: 105, one a conv (99
     for EPMF: `launches_epilogue`). Prints the batched path's scans/s;
  6. train: (a) the train view (flip, 7° rotation, a crop offset, a fixed
     ColorJitter) with return_points through K2 and K1, bit-equal to the
     same call with the plain fills; (b) one float32 train step at a small
     size on the card against the CPU: every loss term within 1e-4
     relative, BN running statistics within 1e-5 relative, and each
     parameter gradient within 1e-3 of its norm in the same step run in
     float64 (check_train_reference says why not float32); (c) the full-width
     train path: the Trainer on in-memory synthetic scans (PMF-ResNet34,
     bf16, batch 8, 256x1024 crop, 32768 points, point-domain Lovász), 2
     warm-up and 8 timed steps and one validation pass, with finite losses,
     parameters and BN statistics changed, confusion matrices summing to the
     labelled pixels and both kernels launched; prints ms/step, scans/s,
     the split of one step into view/forward/loss/backward/optimizer (CUDA
     events) and the peak device memory. The kernels' launch counts over
     (c) are `launches_train` in the kernel line;
  7. EPMF (configs/experiments/epmf_kitti.yaml: the V2 view at 320x1280,
     131072 points a scan): (a) K2 on its 64-bit-key branch at the EPMF
     eval batch (8 scans, forced ties) and K1 on one EPMF scan (17 index
     bits), each held to its plain version exactly and timed as in phase 3;
     (b) EPMFNet in float32 on the card against the CPU at 2x64x128 (base 8),
     as phase 4, and one float32 EPMF train step with the multi-task loss,
     as phase 6(b); (c) batched EPMF-ResNet34 eval at full width (base 32,
     bf16, batch 8): build_v2_batch → EPMFNet → argmax, the kernel fill
     equal to the plain fill, one scan through Inference.run's EPMF branch
     with KNN, both kernels launched (their counts read around this phase
     alone: `launches_epmf`), scans/s; (d) the EPMF Trainer at full width
     (bf16, train batch 2 and validation batch 4 at 320x1280, multi-task
     loss, image-domain Lovász as the config sets), 2 warm-up and 8 timed
     steps and one validation pass, checked as (6c) and σ trained; ms/step,
     the step split, the peak memory (`launches_epmf_train`);
  8. SalsaNext (configs/experiments/salsanext_kitti.yaml: the range view at
     64x2048, 131072 points a scan, float32): (a) K1 at the range batch (8
     scans, 17 index bits, forced ties) held to its plain version exactly
     and timed as in phase 3 (`range_*` keys); (b) SalsaNext in float32 on
     the card against the CPU at 2x16x128 (base 8), as phase 4, and one
     float32 SalsaNext train step, as 6(b); (c) batched SalsaNext eval at
     full width (base 32, batch 8): build_range_batch → SalsaNext → argmax,
     the K1 fill equal to the plain fill, one scan through
     SalsaNextInference.run with KNN, K1 launched (`launches_salsanext`),
     scans/s, and one bf16 forward of the batch (the conv epilogue's 51); (d) the SalsaNext Trainer at full width (batch 8, the yaml's
     point augmentation, reversed yaw bounds included), 2 warm-up and 8
     timed steps and one validation pass, checked as (6c); ms/step, the
     step split, the peak memory (`launches_salsanext_train`). TF32 is off
     for the whole run, so float32 convolutions run in float32;
  9. nuScenes (configs/experiments/*_nuscenes.yaml at full width, 17
     classes, on keyframes of data/synthetic.py: make_nuscenes_inputs, six
     cameras of 65536-point scans): (a) K2 at the PMF train view (3 items,
     640x960, 64-bit keys) and K1 on one eval item (896x1600, 16 index
     bits), each with forced ties held to its plain version exactly and
     timed as in phase 3 (`nusc_*` keys), and the point Lovász's winner
     flags (K1) against K2's mask and labels; (b) a small PMFNet on the
     "cam" view, a small EPMFNet on the camera-frame V2 view with each
     camera's fovs, card vs CPU as phase 4, and one float32 PMF nuScenes
     train step as 6(b); (c) PMF-ResNet34 eval (bf16, 896x1600):
     NuscenesInference.run over a warm-up keyframe and 2 more with KNN,
     18 K1 launches, the ASPP kernel and the conv epilogue launched by the
     first item's eager forward and the second's warm-up and capture of
     the net's CUDA graphs (models/graphs.py), which the later items
     replay, ms/keyframe and the merged coverage, then the batched
     validation view at batch 4 (K2, scans/s) (`launches_nusc`), then
     PMF-ResNet50 (the keyframe cell's net) on one item at 896x1600 (the
     conv epilogue's 122 eagerly, 244 at the second call's warm-up and
     capture, none in the replays after it); (d) the PMF nuScenes
     Trainer (batch 3, 640x960, point Lovász; `launches_nusc_train`); (e)
     a warm-up keyframe and one more through NuscenesInference's EPMF
     branch at 640x1280, counted as (c) (`launches_nusc_epmf`), one EPMF
     train step at batch 6, 320x1088, with
     its peak memory, and one scan through SalsaNextInference's nuScenes
     branch at 32x2048 (`launches_nusc_salsanext`);
 10. A2D2 and SensatUrban (configs/experiments/epmf_a2d2.yaml and
     pmf_sensat.yaml at full width, on data/synthetic.py's make_a2d2_inputs,
     scans of 27000 returns with their stored pixels in 1208x1920 images
     padded to 32768 points, and make_sensat_frame, a tile of 2e6 points,
     1200x1200 cells): (a) K2 at the A2D2 train view (6 scans, 320x960,
     32-bit keys, the trainer's draws) and validation view (10 scans,
     480x1280), K1 on one scan at A2D2Inference's window (480x1280, 15 index
     bits), each with forced ties held to its plain version exactly and
     timed as in phase 3 (`a2d2_*`, `a2d2_val_*` keys); (b) a small EPMFNet
     on the pixel-index V2 view and a small PMFNet on the BEV batch (eval,
     and a train crop of quarter turns) card vs CPU as phase 4, one float32
     EPMF A2D2 train step and one SensatUrban train step (Dice, AMSGrad) as
     6(b); (c) EPMF-ResNet34 A2D2 (bf16): A2D2Inference.run over 4 scans after a
     warm-up one (K1 4 launches; the first of the 4 captures the net's
     CUDA graphs, all 4 replay them), the batched validation view at batch 10 (K2, scans/s)
     (`launches_a2d2`), the Trainer at batch 6, 320x960, multi-task loss
     (K2 only; `launches_a2d2_train`); (d) PMF-ResNet34 SensatUrban
     (float32, TF32 off): SensatInference.run at scales 320/448/576 with
     the 7 test-time views (34 windows), then with KNN, and the Trainer at
     batch 4, 320x320 with Dice and AMSGrad, with the redraws it took;
 11. the training runtime: (a) tools/train.py's main on a SemanticKITTI tree
     on disk (data/synthetic.py: write_kitti_tree, KT + KV scans of 32768
     points with 1241x376 PNGs) at pmf_kitti.yaml's shapes with batch 8 and a
     torchvision-named ResNet34 state_dict from a seed as pretrained_weights,
     --overwrite-policy delete, 2 epochs: the encoder's tensors equal the
     state_dict's, the run directory's layout (settings.json, log/, code/,
     checkpoint/), finite losses, both kernels launched
     (`launches_cli_train`); ms/step of epoch 1 against 6(c)'s in-memory
     Trainer, the data-time share and which reader ran (native or numpy);
     (b) init_distributed at world 1 on NCCL: the small float32 step of
     parallel/dryrun.py with the group up equal to it without (1 ulp), the
     full-width Trainer's ms/step without and with the group, both kernels
     launched with it (`launches_ddp_train`);
 12. the spatial split (parallel/spatial.py): two processes share the card
     over gloo as data 1 x model 2 (`split_phase`): (a) PMF-ResNet34
     nuScenes eval at 896x1600, batch 4, split against one process
     (float32 probabilities 1e-4, bf16 argmax >= 99.5 %), each rank's peak
     memory and ms/forward beside the unsplit run's; (b) the PMF nuScenes
     train step at 640x960, batch 3 (K2 with return_points, K1's flags),
     losses 1e-4 in float32 and gradients 1e-3 of their norm in float64 on
     its first item, each rank's peak memory, and the float32 gradients'
     distance from the unsplit step's without the Lovász terms (λ = 0, no
     points) and with remat; (c) parallel/dryrun.py's small step in float64
     at model 2 equal to one process; both kernels launched
     (`launches_split`, the two ranks' counts over (a) and (b));
 13. remat (`remat_phase`): (a) the PMF Trainer of 6(c) and the EPMF
     Trainer of 7(d) without and with the config's `remat`, peak memory,
     ms/step and the loss terms within 1e-4, and the float32 PMF nuScenes
     step of 12(b) without and with it; (b) a float64 PMF step on one
     full-width train item with remat equal to the step without it
     (gradients 1e-10 of their norm, BN statistics and the generator's
     state equal); (c) the same under phase 12's split; (e) the Trainer's
     `profile_dir` trace: one file, train iterations 2-4, CUDA kernel
     events (there is no 13(d) and no phase 14: the benchmark's cells and
     its `mfu.*` metrics measure what they printed, and the other phases
     keep their numbers);
 15. ASPP's branch kernel at every shape the paths above ran it at
     (phases 5-13, as `AsppWatch` recorded them: the KITTI, nuScenes and
     A2D2 eval batches, the per-scan loops, the Trainers' validation),
     with random operands in the recorded layout: each branch within 2
     bf16 ulps of its largest output of the plain convs (cuDNN) and within
     1 ulp of the float32 convs of the same bf16 operands, the buffer's
     pooled slice untouched (`seen` in the kernel line).

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a CUDA card the script exits 1 and
prints neither.
"""
import copy
import importlib.util
import itertools
import json
import os
import re
import shutil
import statistics
import sys
import time

import numpy as np
import torch

from pmf_tpu_torch.utils.timing import card_name, keys_numbers, rasterize_numbers

H, W, B, N, F = 384, 1232, 8, 32768, 6
TH, TW = 256, 1024          # the train view (bench.py:67, pmf_kitti.yaml proj_ht/proj_wt)
HE, WE, NE = 320, 1280, 131072  # EPMF's V2 view and point buffer (epmf_kitti.yaml PVconfig)
BT, BV = 2, 4               # EPMF's train and validation batches (epmf_kitti.yaml batch_size)
RH, RW, RN, RB = 64, 2048, 131072, 8  # SalsaNext's range view and batch (salsanext_kitti.yaml)
# nuScenes (configs/experiments/*_nuscenes.yaml): PMF's canvas, eval view, points, train view
# and batches; EPMF's eval and train views and train batch; SalsaNext's range view
NCH, NCW, NH, NW, NN = 900, 1600, 896, 1600, 65536
NTH, NTW, NBT, NBV = 640, 960, 3, 4
EH, EW, ETH, ETW, EBT = 640, 1280, 320, 1088, 6
SH, SW = 32, 2048
# A2D2 (configs/experiments/epmf_a2d2.yaml): the canvas, the eval and train views, the point
# buffer, the train and validation batches
AH, AW, AEH, AEW, ATH, ATW, AN, ABT, ABV = 1208, 1920, 480, 1280, 320, 960, 32768, 6, 10
PIX_KEYS = ("points", "labels", "valid", "rows", "cols", "image", "img_h", "img_w")
# SensatUrban (configs/experiments/pmf_sensat.yaml): the crop and the batch; the synthetic tile
# is about SF x SF cells (120 x 120 m at 0.1 m)
SS, SBT, SF = 320, 4, 1200
SCALES = (320, 448, 576)    # infer_sensat's default window sizes
# the train CLI on files (phase 11): scans of sequences 00 (train) and 08 (validation), and
# KITTI's image size
KT, KV, KH, KW = 80, 16, 376, 1241


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def short_name(key: str) -> str:
    key = re.sub(r"^void |\(anonymous namespace\)::", "", key)
    return re.match(r"[^(]*", key).group(0).strip()[:70]


def trace(name: str, fn, smi: str, iters: int = 20) -> None:
    """Print the per-pass split of `iters` calls of `fn`: the host's time per
    call (perf_counter around the calls, before the device is waited for),
    each device pass's time per call and the host's busiest operations
    (torch.profiler, CPU and CUDA activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = sorted(((e.self_device_time_total / iters, e.count / iters, short_name(e.key))
                  for e in events if e.device_type == DeviceType.CUDA), reverse=True)
    cpu = sorted(((e.self_cpu_time_total / iters, short_name(e.key))
                  for e in events if e.device_type == DeviceType.CPU
                  and "synchronize" not in e.key.lower()
                  and not e.key.startswith("Activity Buffer")), reverse=True)[:6]
    total = sum(t for t, _, _ in dev)
    print(f"[trace] {name}: host {host_us:.2f} us/call (no profiler); device "
          f"{total:.2f} us/call in {len(dev)} passes on {smi}"
          + ("" if dev else " (the trace holds no device time)"))
    for t, n, k in dev:
        print(f"[trace]   device {t:9.3f} us/call  x{n:g}  {k}")
    for t, k in cpu:
        print(f"[trace]   host   {t:9.3f} us/call (profiled)  {k}")


def force_ties(rows, cols, depth, keep, seed: int, h: int = H):
    """Copy some points onto other points' pixel and depth (equal dq at a
    higher or lower index), drop some, and push some off the h-row image."""
    rng = np.random.default_rng(seed)
    rows, cols, depth, keep = (t.clone() for t in (rows, cols, depth, keep))
    n = rows.shape[1]
    src = torch.from_numpy(rng.integers(0, n, (rows.shape[0], n // 8))).to(rows.device)
    dst = torch.from_numpy(rng.integers(0, n, (rows.shape[0], n // 8))).to(rows.device)
    for t in (rows, cols, depth, keep):
        t.scatter_(1, dst, t.gather(1, src))
    keep[:, :100] = False
    rows[:, 100:120] = h + 5
    cols[:, 120:140] = -3
    return rows, cols, depth, keep


def random_points(dev, seed: int, b: int, n: int, pixels: int = 0):
    """(rows, cols, depth, keep, values [b, n, F]) on the card: points over
    the image with forced ties (as `force_ties`), depths on quantum edges
    and below 0; or, with `pixels`, every point on a square of that many
    pixels, at 8 depth quanta (heavy contention, ties at equal dq)."""
    rng = np.random.default_rng(seed)
    if pixels:
        side = int(round(pixels ** 0.5))
        rows = H // 2 + rng.integers(0, side, (b, n))
        cols = W // 2 + rng.integers(0, side, (b, n))
        depth = rng.integers(64, 72, (b, n)) / 64 + rng.uniform(0, 1 / 64, (b, n))
    else:
        rows = rng.integers(-2, H + 2, (b, n))
        cols = rng.integers(-2, W + 2, (b, n))
        depth = rng.uniform(0.5, 80, (b, n))
        depth[:, 200:260] = np.floor(depth[:, 200:260] * 64) / 64
        depth[:, 260:270] = -1.0
    keep = rng.random((b, n)) > 0.1
    values = rng.normal(size=(b, n, F)).astype(np.float32)
    rows, cols, depth, keep, values = (
        torch.from_numpy(a).to(dev) for a in (rows.astype(np.int32), cols.astype(np.int32),
                                              depth.astype(np.float32), keep, values))
    if not pixels:
        rows, cols, depth, keep = force_ties(rows, cols, depth, keep, seed)
    return rows, cols, depth, keep, values


def hold_rasterize(label: str, rows, cols, depth, keep, values, h: int = H, w: int = W):
    """K2 on these points into an h x w image, held to its plain version bit
    for bit; returns the max abs error."""
    from pmf_tpu_torch.ops import rasterize

    args = (rows, cols, depth, keep, values, h, w)
    canvas, mask = rasterize.rasterize_zbuffer(*args)
    torch.cuda.synchronize()
    want_c, want_m = rasterize.rasterize_zbuffer_plain(*args)
    if not (torch.equal(mask, want_m) and torch.equal(canvas, want_c)):
        fail(f"rasterize_zbuffer differs from its plain version ({label}): "
             f"{(mask != want_m).sum().item()} mask bits, "
             f"{(canvas != want_c).sum().item()} canvas values")
    b, n = rows.shape
    print(f"[kernels] rasterize_zbuffer == plain ({label}) at B={b} N={n} {h}x{w} "
          f"F={values.shape[-1]}: {int(mask.sum())} occupied pixels")
    return (canvas - want_c).abs().max().item()


def hold_keys(label: str, pix, key, h: int = H, w: int = W):
    """K1 on these keys into an h x w image, held to its plain version bit
    for bit; returns the max abs error."""
    from pmf_tpu_torch.ops import zbuffer

    got = zbuffer.zbuffer_keys(pix, key, h, w)
    torch.cuda.synchronize()
    want = zbuffer.zbuffer_keys_plain(pix, key, h, w)
    if not torch.equal(got, want):
        fail(f"zbuffer_keys differs from its plain version ({label}): "
             f"{(got != want).sum().item()} pixels")
    b, n = pix.shape
    print(f"[kernels] zbuffer_keys == plain ({label}) at B={b} N={n} {h}x{w}: "
          f"{int((got != zbuffer.IMAX).sum())} occupied pixels")
    return float((got.long() - want.long()).abs().max().item())


def print_numbers(name: str, e: dict, smi: str, prefix: str = ""):
    p = lambda k: e[prefix + k]
    print(f"[timing] {name}{' (' + prefix.rstrip('_') + ')' if prefix else ''}: ms "
          f"{p('ms'):.5g} (host-inclusive), device_ms {p('device_ms'):.5g} (CUDA graph), "
          f"bound {p('bound_ms'):.5g} ({p('bound_by')}), plain {p('plain_ms'):.5g}, library "
          f"{p('library_ms'):.5g} on {smi}")


def check_kernels(dev, cfg, batch, smi):
    from pmf_tpu_torch.data.perspective_pipeline import view_geometry
    from pmf_tpu_torch.ops import rasterize, zbuffer
    from pmf_tpu_torch.ops.scatter import packed_keys

    rows, cols, keep, depth, vals, _ = view_geometry(*batch, cfg)
    rows, cols, depth, keep = force_ties(rows, cols, depth, keep, seed=1)
    vals = vals.contiguous()
    entries = []

    # K2 at the batched path's shapes, then the cases off that path: the
    # 64-bit keys (N > 65535) and the key-width boundary, contention, and a
    # batch with every point dropped
    err = hold_rasterize("main path, forced ties", rows, cols, depth, keep, vals)
    for label, (b, n, pixels) in (("64-bit keys", (1, 131072, 0)),
                                  ("key-width boundary", (2, 65535, 0)),
                                  ("key-width boundary", (2, 65536, 0)),
                                  ("contention: every point on 64 pixels", (2, N, 64))):
        hold_rasterize(label, *random_points(dev, 7 + n + pixels, b, n, pixels))
    hold_rasterize("every point dropped", rows[:2], cols[:2], depth[:2],
                   torch.zeros_like(keep[:2]), vals[:2])
    args = (rows, cols, depth, keep, vals, H, W)
    entries.append({
        "name": "rasterize_zbuffer", "route": "cuda",
        "source": "pmf_tpu_torch/csrc/rasterize.cu",
        "replaces": "pmf_tpu/ops/pallas/tile_fill.py:148",
        "max_abs_err": err, **rasterize_numbers(*args),
    })

    # K1 at the per-scan path's shapes (one scan), once for the batch, and
    # on the contention and all-dropped points
    pix, key, _ = packed_keys(rows, cols, depth, keep, H, W, 1 / 64)
    hold_keys("main path, forced ties", pix.contiguous(), key.contiguous())
    p1, k1 = pix[:1].contiguous(), key[:1].contiguous()
    err = hold_keys("per-scan path", p1, k1)
    crows, ccols, cdepth, ckeep, _ = random_points(dev, 9, 2, N, pixels=64)
    hold_keys("contention: every point on 64 pixels",
              *packed_keys(crows, ccols, cdepth, ckeep, H, W, 1 / 64)[:2])
    hold_keys("every point dropped",
              *packed_keys(rows[:2], cols[:2], depth[:2], torch.zeros_like(keep[:2]),
                           H, W, 1 / 64)[:2])
    numbers, library_keys = keys_numbers(p1, k1, H, W, int(keep[0].sum()))
    entries.append({
        "name": "zbuffer_keys", "route": "cuda",
        "source": "pmf_tpu_torch/csrc/zbuffer_keys.cu",
        "replaces": "pmf_tpu/ops/pallas/zbuffer.py:45",
        "max_abs_err": err, **numbers,
    })
    for e in entries:
        print_numbers(e["name"], e, smi)

    trace("rasterize_zbuffer", lambda: rasterize.rasterize_zbuffer(*args), smi)
    trace("zbuffer_keys", lambda: zbuffer.zbuffer_keys(p1, k1, H, W), smi)
    trace("zbuffer_keys library call (full + scatter_reduce_)", library_keys, smi)
    return entries


ASPP_DIL = (6, 12, 18)
# (label, N, C, H, W): the ASPPs of the nets at their eval batches and one scan
ASPP_SHAPES = (("EPMF camera decoder", 8, 512, 20, 80), ("PMF lidar head", 8, 256, 24, 77),
               ("EPMF lidar head", 8, 256, 10, 40), ("PMF lidar head, one scan", 1, 256, 24, 77))
ASPP_ULPS, ASPP_F32_ULPS = 2.0, 1.0  # kernel vs plain (cuDNN), vs float32 sums
L2_PAST_BYTES = 200_000_000  # bytes through the card between two uses of a tensor: 4x its L2
# the conv epilogue's launches an eval forward makes in bf16, one a conv
# (tests/test_torch_epilogue.py: NETS); a float32 forward makes none
EPILOGUES = {"PMFNet": 105, "EPMFNet": 99, "PMFNet-ResNet50": 122, "SalsaNext": 51}
# the train-mode epilogue's launches a bf16 train step makes, four a BN it takes
# (tests/test_torch_epilogue_train.py: TRAIN_NETS); a float32 step makes none
BN_TRAIN_STEP = {"PMFNet": 4 * 94, "EPMFNet": 4 * 86}
# bytes a train-mode epilogue moves an element, forward and backward (ops/epilogue_train.py)
BN_TRAIN_BYTES = {"act_bn": 16, "act_bn_residual": 18, "bn_relu": 16, "bn_relu_bias": 16,
                  "bn_sigmoid_bias": 16, "bn": 16, "bn_residual_relu": 22}


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at |v| > 0."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def aspp_operands(dev, nb: int, c: int, h: int, w: int, channels_last: bool, seed: int):
    """Random x [nb, c, h, w] (bf16, in the layout asked for), the four
    branches' float32 kernels and biases, and a zero [nb, h, w, 5c] buffer."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(nb, c, h, w, generator=g).to(dev, torch.bfloat16)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    ws = [(torch.randn(c, c, k, k, generator=g) / (k * k * c) ** 0.5).to(dev)
          for k in (1, 3, 3, 3)]
    bs = [(torch.randn(c, generator=g) * 0.1).to(dev) for _ in range(4)]
    return x, ws, bs, torch.zeros((nb, h, w, 5 * c), dtype=torch.bfloat16, device=dev)


def hold_aspp(label: str, x, ws, bs, dil, out) -> tuple:
    """The kernel into `out` against its plain version (cuDNN) and the
    float32 convs of the same bf16 operands: each branch within ASPP_ULPS /
    ASPP_F32_ULPS bf16 ulps of its largest output, the pooled slice left
    untouched. Returns the largest of each, in ulps."""
    from pmf_tpu_torch.ops import aspp

    c = x.shape[1]
    ref, truth = torch.zeros_like(out), out.float()
    aspp.aspp_branches(x, ws, bs, dil, out)
    aspp.aspp_branches_plain(x, ws, bs, dil, ref)
    aspp.aspp_branches_plain(x.float(), [t.to(torch.bfloat16).float() for t in ws], bs, dil,
                             truth)
    torch.cuda.synchronize()
    errs, errs32 = [], []
    for b in range(4):
        sl = slice(c * (1 + b), c * (2 + b))
        errs.append((out[..., sl].float() - ref[..., sl].float()).abs().max().item()
                    / bf16_ulp(ref[..., sl].float().abs().max().item()))
        errs32.append((out[..., sl].float() - truth[..., sl]).abs().max().item()
                      / bf16_ulp(truth[..., sl].abs().max().item()))
    if max(errs) > ASPP_ULPS or max(errs32) > ASPP_F32_ULPS or out[..., :c].any():
        fail(f"[aspp] {label}: the kernel's branches differ from the plain convs by {errs} "
             f"ulps (limit {ASPP_ULPS}), from the float32 sums by {errs32} (limit "
             f"{ASPP_F32_ULPS}), or it wrote the pooled slice")
    nb, _, h, w = x.shape
    print(f"[aspp] {label} {nb}x{c}x{h}x{w} dilations {tuple(dil)}: kernel vs plain "
          f"{max(errs):.3g} bf16 ulps of each branch's largest output (limit {ASPP_ULPS}), vs "
          f"float32 sums {max(errs32):.3g} (limit {ASPP_F32_ULPS}); pooled slice untouched")
    return max(errs), max(errs32)


def check_aspp(dev, smi) -> list:
    """3(b): ASPP's branch kernel held (`hold_aspp`) and timed at each of
    ASPP_SHAPES (see the module docstring). Returns one dict of numbers a
    shape."""
    import torch.nn.functional as F

    from pmf_tpu_torch.ops import aspp
    from pmf_tpu_torch.utils.flops import H100_BF16_PEAK_FLOPS
    from pmf_tpu_torch.utils.timing import HBM_BYTES_PER_S, device_ms, time_ms

    rows = []
    for i, (label, nb, c, h, w) in enumerate(ASPP_SHAPES):
        x, ws, bs, out = aspp_operands(dev, nb, c, h, w, True, 40 + i)
        ref = torch.zeros_like(out)
        err, err32 = hold_aspp(label, x, ws, bs, ASPP_DIL, out)

        def library(xx):
            for b in range(4):
                d = ASPP_DIL[b - 1] if b else 1
                F.conv2d(xx, ws[b].to(torch.bfloat16), bs[b].to(torch.bfloat16),
                         padding=d if b else 0, dilation=d)

        flops = aspp.live_flops(nb, h, w, c, ASPP_DIL)
        n_bytes = 2 * (x.numel() + 28 * c * c + nb * h * w * 4 * c)
        t_ops, t_bytes = flops / H100_BF16_PEAK_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        x_nchw = x.contiguous()
        e = {"label": label, "shape": [nb, c, h, w], "max_ulps": err, "max_ulps_f32": err32,
             "gflop": flops / 1e9,
             "ms": time_ms(lambda: aspp.aspp_branches(x, ws, bs, ASPP_DIL, out)),
             "device_ms": device_ms(lambda: aspp.aspp_branches(x, ws, bs, ASPP_DIL, out)),
             "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "plain_ms": time_ms(lambda: aspp.aspp_branches_plain(x, ws, bs, ASPP_DIL, ref)),
             "library_ms": device_ms(lambda: library(x)),
             "library_nchw_ms": device_ms(lambda: library(x_nchw))}
        print(f"[timing] aspp_branches ({label}): ms {e['ms']:.5g} (host-inclusive), device_ms "
              f"{e['device_ms']:.5g} (CUDA graph), bound {e['bound_ms']:.5g} ({e['bound_by']}: "
              f"{flops / 1e9:.4g} GFLOP, {n_bytes / 1e6:.4g} MB), plain {e['plain_ms']:.5g}, "
              f"library {e['library_ms']:.5g} (cuDNN as the nets call it), "
              f"{e['library_nchw_ms']:.5g} (on an NCHW copy) on {smi}")
        rows.append(e)
        if i == 0:
            trace("aspp_branches", lambda: aspp.aspp_branches(x, ws, bs, ASPP_DIL, out), smi)
    return rows


def epilogue_chain(y, bias, act, a, b, res, post):
    """The ops the nets ran after a cuDNN conv before the kernel: the bias
    added in place (as F.conv2d adds it), the activation, BN's x·a + b in
    bf16, the residual, the closing relu; each a pass of its own."""
    from pmf_tpu_torch.models import layers

    y = layers._ACTS[act](y.add_(bias.to(y.dtype)[:, None, None]))
    if a is not None:
        y = y * a.to(y.dtype)[:, None, None] + b.to(y.dtype)[:, None, None]
    if res is not None:
        y = y + res
    return layers._ACTS[post](y)


def load_card_tests():
    """tests/test_torch_cuda.py as a module, loaded by its path: a `tests`
    package installed elsewhere would shadow the repository's folder."""
    spec = importlib.util.spec_from_file_location("test_torch_cuda", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "test_torch_cuda.py"))
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)
    return card_tests


def check_epilogue(dev, smi) -> list:
    """3(c): the conv epilogue kernel at each of the card test's
    EPILOGUE_SHAPES (tests/test_torch_cuda.py), in place on y, held to its
    plain twin on the same card tensors (within 1 bf16 ulp of each element;
    equal but for sigmoid) with the residual untouched; timed as K1 and K2
    (`ms`, `device_ms`) but cycling through copies of the operands, each
    call's bytes past the L2 since its last use (`copies`), beside its bound
    (one read and one write of y, one read of the residual, at 3.35 TB/s),
    the twin (`plain_ms`) and PyTorch's chain of passes the nets ran before
    it (`library_ms`), on the same copies. Returns one dict of numbers a
    shape."""
    from pmf_tpu_torch.ops import epilogue
    from pmf_tpu_torch.utils.timing import HBM_BYTES_PER_S, device_ms, time_ms
    card_tests = load_card_tests()

    rows = []
    for i, (label, (variant, nb, c, h, w)) in enumerate(card_tests.EPILOGUE_SHAPES.items()):
        y, bias, act, a, b, res, post = card_tests.epilogue_operands(dev, variant, nb, c, h, w,
                                                                     80 + i)
        res_before = None if res is None else res.clone()
        want = epilogue.conv_epilogue_plain(y.clone(), bias, act, a, b, res, post)
        got = epilogue.conv_epilogue(y, bias, act, a, b, res, post)
        torch.cuda.synchronize()
        ulps = card_tests.bf16_ulps(got, want)
        unequal = int((got != want).sum())
        if ulps > 1.0 or (unequal and act != "sigmoid") or (
                res is not None and not torch.equal(res, res_before)):
            fail(f"[epilogue] {label}: the kernel differs from its twin by {ulps} bf16 ulps at "
                 f"{unequal} elements, or it wrote the residual")
        del want, res_before
        n_bytes = 2 * y.numel() * (3 if res is not None else 2)
        k = max(1, min(64, -(-L2_PAST_BYTES // n_bytes)))   # copies: 200 MB between two uses
        iters = k * max(1, round(20 / k))
        copies = [(y.clone(), None if res is None else res.clone()) for _ in range(k)]

        def cycled(fn):
            turn = itertools.cycle(copies)
            return lambda: fn(*next(turn))

        kernel = cycled(lambda yy, rr: epilogue.conv_epilogue(yy, bias, act, a, b, rr, post))
        e = {"label": label, "variant": variant, "shape": [nb, c, h, w], "max_ulps": ulps,
             "unequal": unequal, "mb": n_bytes / 1e6, "copies": k,
             "ms": time_ms(kernel, iters=iters),
             "device_ms": device_ms(kernel, iters=iters),
             "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
             "plain_ms": time_ms(cycled(lambda yy, rr: epilogue.conv_epilogue_plain(
                 yy, bias, act, a, b, rr, post)), iters=max(5, k)),
             "library_ms": device_ms(cycled(lambda yy, rr: epilogue_chain(
                 yy, bias, act, a, b, rr, post)), iters=iters)}
        print(f"[timing] conv_epilogue ({label}, {variant}, {nb}x{c}x{h}x{w}): {ulps:.3g} ulps "
              f"from the twin at {unequal} of {y.numel()} elements; ms {e['ms']:.5g} "
              f"(host-inclusive), device_ms {e['device_ms']:.5g} (CUDA graph), bound "
              f"{e['bound_ms']:.5g} (bytes: {n_bytes / 1e6:.4g} MB), plain {e['plain_ms']:.5g}, "
              f"library {e['library_ms']:.5g} (PyTorch's chain), over {k} copies on {smi}")
        rows.append(e)
        if i == 0:
            trace("conv_epilogue", kernel, smi)
        del y, res, copies, kernel
        torch.cuda.empty_cache()
    return rows


def bn_train_chain(family, act, post, yb, res, gout, bn):
    """PyTorch's chain as the nets ran a train-mode BN before the kernels,
    forward and backward: on the conv's output with its bias (bf16),
    conv_block's BN(act(y)) + residual or conv_bn's post(act(BN(y)) +
    residual)."""
    from pmf_tpu_torch.models import layers

    y = yb.clone().requires_grad_()
    r = None if res is None else res.clone().requires_grad_()
    out = layers._chain(y, act, bn, r, post) if family == "act_bn" else \
        layers._chain(bn(y), act, None, r, post)
    out.backward(gout)


def check_epilogue_train(dev, smi) -> list:
    """3(d): the train-mode conv epilogue (ops/epilogue_train.py) at each of
    the card test's BN_TRAIN_SHAPES (tests/test_torch_cuda.py), forward and
    backward, held to its plain twin on the same card tensors as the card
    test holds it (`bn_train_gaps`); timed: `ms` the autograd Function's
    forward and backward (CUDA events, host-inclusive), `device_ms` its
    four passes alone in a CUDA graph, cycling through copies of y so that
    200 MB pass between two uses of one; its bound (the bytes of
    BN_TRAIN_BYTES at 3.35 TB/s), the twin (`plain_ms`) and PyTorch's chain
    as the nets ran it (`library_ms`, forward and backward, CUDA events).
    Returns one dict of numbers a shape."""
    from pmf_tpu_torch.models import layers
    from pmf_tpu_torch.ops import epilogue_train as T
    from pmf_tpu_torch.utils.timing import HBM_BYTES_PER_S, device_ms, time_ms
    card_tests = load_card_tests()

    rows = []
    for label, (case, nb, c, h, w) in card_tests.BN_TRAIN_SHAPES.items():
        family, act, _, post, _ = card_tests.BN_TRAIN_CASES[case]
        ops = card_tests.bn_train_operands(dev, case, nb, c, h, w, 90 + c)
        y, gout, bias, res, gamma, beta, running = ops
        want = card_tests.bn_train_run(T.bn_epilogue_plain, case, *ops)
        got = card_tests.bn_train_run(T.bn_epilogue, case, *ops)
        torch.cuda.synchronize()
        gaps = card_tests.bn_train_gaps(got, want, family)
        limits = {"out_ulps": float("inf"), "dres_unequal": 1e-6 * y.numel()}
        if any(v > limits.get(k, 1e-5) for k, v in gaps.items()):
            fail(f"[epilogue_train] {label}: the kernels part from their twin by {gaps}")
        del want, got
        n_bytes = BN_TRAIN_BYTES[case] * y.numel()
        k = max(1, min(64, -(-L2_PAST_BYTES // n_bytes)))
        iters = k * max(1, round(10 / k))
        copies = itertools.cycle([y.clone() for _ in range(k)])

        def passes():
            yy = next(copies)
            stats = T._stats_kernel(yy, bias, gamma, beta, None, 1e-5, 0.1, family, act)
            out = T._apply_kernel(yy, res, bias, stats, family, act, post)
            g, ld = T._pixel_rows(gout)
            grads, gres = T._grad_sums_kernel(g, ld, yy, out, bias, stats, family, act, post)
            if gres is not None:
                g, ld = gres, c
            T._grad_apply_kernel(g, ld, yy, bias, stats, grads, family, act)

        bn = layers.BatchNorm2d(c).to(dev).train()
        yb = (y.float() + (0 if bias is None else bias[:, None, None])).to(torch.bfloat16)
        yb = yb.contiguous(memory_format=torch.channels_last)
        e = {"label": label, "case": case, "shape": [nb, c, h, w], **gaps,
             "mb": n_bytes / 1e6, "copies": k,
             "ms": time_ms(lambda: card_tests.bn_train_run(T.bn_epilogue, case, next(copies),
                                                           *ops[1:]), iters=iters),
             "device_ms": device_ms(passes, iters=iters),
             "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
             "plain_ms": time_ms(lambda: card_tests.bn_train_run(T.bn_epilogue_plain, case,
                                                                 *ops), iters=3),
             "library_ms": time_ms(lambda: bn_train_chain(family, act, post, yb, res, gout,
                                                                 bn), iters=5)}
        e["share_of_bound"] = e["bound_ms"] / e["device_ms"]
        print(f"[timing] bn_epilogue ({label}, {case}, {nb}x{c}x{h}x{w}): gaps from the twin "
              f"{json.dumps(gaps)}; ms {e['ms']:.5g} (forward and backward, host-inclusive), "
              f"device_ms {e['device_ms']:.5g} (its four passes, CUDA graph), bound "
              f"{e['bound_ms']:.5g} (bytes: {n_bytes / 1e6:.4g} MB; {100 * e['share_of_bound']:.1f}"
              f" %), plain {e['plain_ms']:.5g}, library {e['library_ms']:.5g} (PyTorch's chain, "
              f"forward and backward), over {k} copies on {smi}")
        rows.append(e)
        del ops, y, gout, res, copies, yb
        torch.cuda.empty_cache()
    return rows


def bn_train_launches() -> int:
    """The train-mode epilogue's launches since `reset_launches`."""
    from pmf_tpu_torch.ops import epilogue_train

    torch.cuda.synchronize()
    return epilogue_train.bn_epilogue.launches


class AsppWatch:
    """Watches every ASPP forward from `install()` on (ASPP.forward wrapped,
    host-side only): the forward must launch the ASPP kernel once where its
    conditions hold (CUDA bf16 x with C a multiple of 128, grad off, no row
    split) and never elsewhere. `seen` maps each (N, C, H, W, dilations,
    channels-last) the kernel ran at to its forwards."""
    seen: dict = {}

    @classmethod
    def install(cls):
        from pmf_tpu_torch.models import pmf
        from pmf_tpu_torch.ops import aspp
        from pmf_tpu_torch.parallel import spatial

        forward = pmf.ASPP.forward

        def watched(module, x):
            before = aspp.aspp_branches.launches
            y = forward(module, x)
            ran = aspp.aspp_branches.launches - before
            want = int(x.is_cuda and x.dtype == torch.bfloat16 and x.shape[1] % 128 == 0
                       and not torch.is_grad_enabled() and spatial.active() is None)
            if ran != want:
                fail(f"[aspp] an ASPP forward on {tuple(x.shape)} {x.dtype} (grad "
                     f"{torch.is_grad_enabled()}, split {spatial.active() is not None}) "
                     f"launched the kernel {ran} times, not {want}")
            if ran:
                dil = tuple(b.dilation[0] for b in (module.atrous_block6, module.atrous_block12,
                                                    module.atrous_block18))
                key = (*x.shape, dil, x.is_contiguous(memory_format=torch.channels_last))
                cls.seen[key] = cls.seen.get(key, 0) + 1
            return y

        pmf.ASPP.forward = watched


def check_aspp_seen(dev) -> list:
    """Phase 15: the kernel held (`hold_aspp`) at each shape, dilations and
    layout `AsppWatch` saw it run at, with random operands. Returns one
    dict a shape."""
    if not AsppWatch.seen:
        fail("[aspp] no path ran the ASPP kernel")
    rows = []
    for i, ((nb, c, h, w, dil, cl), n) in enumerate(sorted(AsppWatch.seen.items())):
        x, ws, bs, out = aspp_operands(dev, nb, c, h, w, cl, 60 + i)
        err, err32 = hold_aspp(f"seen {n} times, {'channels-last' if cl else 'NCHW'}", x, ws,
                               bs, dil, out)
        rows.append({"shape": [nb, c, h, w], "dilations": list(dil), "channels_last": cl,
                     "forwards": n, "max_ulps": err, "max_ulps_f32": err32})
        del x, ws, bs, out
    return rows


def ulp(x: torch.Tensor) -> float:
    """The spacing of float32 numbers at |x| (a 0-d tensor)."""
    x = x.abs().float()
    return (torch.nextafter(x, torch.tensor(float("inf"))) - x).item()


def check_reference(dev):
    """float32 port on the card (kernels) against the port on the CPU
    (plain versions) at a small size: mask and labels bit for bit,
    normalized features within 4 ulp of the largest feature, probabilities
    within 1e-4, and the argmax equal where the top-2 margin exceeds 1e-4,
    which must hold for most pixels, with more than one class winning.
    The point ranges (a square root) can round differently in the last
    place on the two devices; one ulp of a range of 64-128 m is 1.3 ulp of
    its normalized value, 2 ulp once both sides are rounded, and the limit
    allows twice that."""
    from pmf_tpu_torch.data import PVConfig, build_batch
    from pmf_tpu_torch.data.synthetic import make_inputs
    from pmf_tpu_torch.models import PMFNet, random_weights

    h, w = 64, 160
    torch.manual_seed(6)
    cfg = PVConfig(canvas_h=h, canvas_w=w + 16, proj_h=h, proj_w=w, n_points=2048)
    raw = make_inputs(np.random.default_rng(5), 2, 2048, h, w)
    model = random_weights(PMFNet(nclasses=20, base_channels=8), seed=6)
    hold_card_to_cpu(dev, "[reference]", lambda d: build_batch(*on(raw, d), cfg), model)


def on(arrays, d):
    """numpy arrays as tensors on device `d`."""
    return [torch.from_numpy(a).to(d) for a in arrays]


def fusion_forward(model, f):
    return model(f[..., :5], f[..., 5:8])


def hold_card_to_cpu(dev, tag: str, view, model, forward=fusion_forward):
    """`view(device)` (a batched eval view: features, mask, labels) and
    `forward(model, features)` (the streams' probabilities, the lidar
    stream's first) on the card against the same on the CPU, held as
    `check_reference` says."""
    from pmf_tpu_torch.ops import argmax_last

    outs = []
    for d in (torch.device("cpu"), dev):
        m = model.to(d)
        with torch.inference_mode():
            f, mask, lab = view(d)
            probs = forward(m, f)
        outs.append([t.cpu() for t in (f, mask, lab, argmax_last(probs[0]), *probs)])
    (f0, m0, l0, a0, p0, *c0), (f1, m1, l1, a1, p1, *c1) = outs
    f_err = (f0 - f1).abs().max().item()
    f_ulp = ulp(f0.abs().max())
    if f_err > 4 * f_ulp or not (torch.equal(m0, m1) and torch.equal(l0, l1)):
        fail(f"{tag} the card's mask or labels differ from the CPU's, or its features "
             f"by {f_err} (tolerance 4 ulp = {4 * f_ulp})")
    err = max((x - y).abs().max().item() for x, y in zip([p0, *c0], [p1, *c1]))
    top2 = p0.topk(2, dim=-1).values
    clear = top2[..., 0] - top2[..., 1] > 1e-4
    n_classes = a0.unique().numel()
    if err > 1e-4 or not torch.equal(a0[clear], a1[clear]):
        fail(f"{tag} float32 probabilities on the card differ from the CPU's by {err}")
    if clear.float().mean() <= 0.9 or n_classes < 2:
        fail(f"{tag} the reference run cannot tell forwards apart: top-2 margin > 1e-4 at "
             f"{clear.float().mean().item():.3f} of the pixels, {n_classes} classes")
    print(f"{tag} card vs CPU at {'x'.join(map(str, m0.shape))}: mask/labels exact "
          f"({int(m0.sum())} occupied pixels), features max abs diff {f_err:.3g} = "
          f"{f_err / f_ulp:.2f} ulp of the largest feature {f0.abs().max().item():.4g} "
          f"(tolerance 4 ulp), probabilities max abs diff {err:.3g} (tolerance 1e-4); argmax "
          f"margin > 1e-4 at {clear.float().mean().item():.4f} of the pixels, {n_classes} "
          f"classes")


def main_path(dev, cfg, batch, raw, smi):
    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.data.perspective_pipeline import _build_batch
    from pmf_tpu_torch.models import PMFNet, random_weights

    torch.manual_seed(0)
    model = random_weights(PMFNet(nclasses=20, base_channels=32, image_backbone="resnet34",
                              dtype=torch.bfloat16), seed=0).to(dev)
    sensor = {"canvas_h": cfg.canvas_h, "canvas_w": cfg.canvas_w, "proj_h": H, "proj_w": W,
              "h_pad": cfg.h_pad, "w_pad": cfg.w_pad, "n_points": N}
    opts = Options(nclasses=20, base_channels=32, compute_dtype="bfloat16",
                   config={"sensor": sensor, "post": {"KNN": {"params": {
                       "knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}}})
    return eval_path(dev, "[main]", "build_batch+PMFNet+argmax", model, opts, build_batch,
                     _build_batch, cfg, batch, raw, (H, W), smi)


def eval_path(dev, tag, name, model, opts, build, build_with_fill, cfg, batch, raw, size, smi,
              aspp_per_call: int = 1, epilogue_per_call: int = EPILOGUES["PMFNet"]):
    """Batched eval (`build` → `model` → argmax) and one scan through the
    Inference.run loop (KNN on), with both kernels' launch counts read
    around them, the ASPP kernel's around one batched call and the scan
    (each must be `aspp_per_call`) and the conv epilogue's likewise (each
    `epilogue_per_call`: one a conv); the batched path against the same with
    the plain fill; its scans/s. Returns the launch counts."""
    from pmf_tpu_torch.ops import argmax_last, aspp, epilogue, rasterize
    from pmf_tpu_torch.tools.infer_kitti import Inference

    b = len(raw[0])
    h, w = size
    scan = {k: a[0] for k, a in zip(
        ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w"), raw)}
    inference = Inference(opts, model, lambda i: scan, 1, dev, ignore=[0], use_knn=True)

    def batched(c):
        f, m, lab = build(*batch, c)
        lidar, _ = model(f[..., :5], f[..., 5:8])
        return f, m, lab, lidar, argmax_last(lidar)

    reset_launches()
    with torch.inference_mode():
        f, m, lab, lidar, pred = batched(cfg)
        per_call = aspp.aspp_branches.launches
        epilogues = epilogue.conv_epilogue.launches
        report = inference.run()
    launches = read_launches()
    if bn_train_launches():
        fail(f"{tag} the train-mode epilogue ran {bn_train_launches()} times on the eval path")
    per_scan = launches["aspp_branches"] - per_call
    epilogues_scan = launches["conv_epilogue"] - epilogues
    if epilogues != epilogue_per_call or epilogues_scan != epilogue_per_call:
        fail(f"{tag} the conv epilogue ran {epilogues} times in one batched call and "
             f"{epilogues_scan} in one scan, not {epilogue_per_call}")
    print(f"{tag} conv epilogue: {epilogues} launches a batched call, {epilogues_scan} a scan")
    print(f"{tag} launches on the main path: {json.dumps(launches)} (one batched call and "
          "one scan)")
    if min(launches.values()) == 0:
        fail(f"{tag} a kernel of the main path was not launched: {launches}")
    if per_call != aspp_per_call or per_scan != aspp_per_call:
        fail(f"{tag} the ASPP kernel ran {per_call} times in one batched call and {per_scan} "
             f"in one scan, not {aspp_per_call}")
    launches["aspp_branches"] = per_call
    launches["conv_epilogue"] = epilogues

    if lidar.shape != (b, h, w, 20) or not torch.isfinite(lidar).all():
        fail(f"{tag} lidar probabilities: shape {tuple(lidar.shape)}, finite "
             f"{bool(torch.isfinite(lidar).all())}")
    if not torch.isfinite(f).all() or f.shape != (b, h, w, 8):
        fail(f"{tag} features are not finite or have the wrong shape")
    if int(pred.min()) < 0 or int(pred.max()) >= 20 or int(lab.min()) < 0 or int(lab.max()) >= 20:
        fail(f"{tag} labels out of range")
    n_classes = pred.unique().numel()
    if n_classes < 2:
        fail(f"{tag} the batched path predicts one class everywhere")
    if not all(np.isfinite(v) for t in ("pixel", "point") for v in report[t].values()):
        fail(f"{tag} Inference.run report is not finite: {report}")
    print(f"{tag} batched: {int(m.sum())} occupied pixels, {n_classes} classes "
          f"predicted ({int(pred.min())}..{int(pred.max())}); one scan through Inference.run: "
          f"point mIoU {report['point']['mIoU']:.4f}, pixel mIoU {report['pixel']['mIoU']:.4f}")

    with torch.inference_mode():
        plain = build_with_fill(*batch, cfg, fill=rasterize.rasterize_zbuffer_plain)
        if not all(torch.equal(x, y) for x, y in zip((f, m, lab), plain)):
            fail(f"{tag} the batched path gives other features, mask or labels with the "
                 "plain fill")
        print(f"{tag} batched path: kernel fill == plain fill (features, mask, labels)")

        for _ in range(2):
            batched(cfg)
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched(cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        profile_step(lambda: batched(cfg), smi, name=f"eval batch ({name})")
    med = statistics.median(times)
    print(f"{tag} batched eval {name}, batch {b}, {h}x{w}, bf16: "
          f"{b / med:.2f} scans/s (median of {len(times)} batches: {med * 1e3:.2f} ms, "
          f"min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) on {smi}")
    return launches


def train_cfg(**kw):
    from pmf_tpu_torch.data import PVConfig

    return PVConfig(canvas_h=H, canvas_w=W + 16, proj_h=H, proj_w=W, proj_ht=TH, proj_wt=TW,
                    h_pad=7, w_pad=3, n_points=N, img_jitter=(0.4, 0.4, 0.4), **kw)


def fixed_aug(b: int, dev, theta_deg=7.0, top=50, left=100):
    """Flip on, a rotation, a nonzero crop offset and a fixed ColorJitter for
    each of `b` scans."""
    from pmf_tpu_torch.data import AugParams

    full = lambda v, dt: torch.full((b,), v, dtype=dt, device=dev)
    jitter = (torch.tensor([[1.2, 0.8, 1.1]], device=dev).expand(b, 3).contiguous(),
              torch.tensor([[2, 0, 1]], device=dev).expand(b, 3).contiguous())
    return AugParams(full(True, torch.bool), full(np.deg2rad(theta_deg), torch.float32),
                     full(top, torch.int64), full(left, torch.int64), jitter)


def check_train_view(dev, batch):
    """(a): build_batch(train=True, return_points=True) through K2 and K1 ==
    the same call with the plain fills, bit for bit."""
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.data.perspective_pipeline import _build_batch
    from pmf_tpu_torch.ops import rasterize, zbuffer

    cfg, aug = train_cfg(), fixed_aug(B, dev)
    with torch.no_grad():
        f, m, lab, (pix, plab, won) = build_batch(*batch, cfg, train=True, aug_override=aug,
                                                  return_points=True)
        torch.cuda.synchronize()
        want = _build_batch(*batch, cfg, True, None, aug, True,
                            fill=rasterize.rasterize_zbuffer_plain, keys=zbuffer.zbuffer_keys_plain)
    names = ("features", "mask", "labels", "pt_pix", "pt_label", "pt_won")
    for name, a, b in zip(names, (f, m, lab, pix, plab, won), (*want[:3], *want[3])):
        if not torch.equal(a, b):
            fail(f"the train view with K2+K1 differs from the plain fills in {name}")
    labelled = int((lab > 0).sum())
    if f.shape != (B, TH, TW, 8) or int((won & (plab > 0)).sum()) != labelled or labelled == 0:
        fail(f"train view: shape {tuple(f.shape)}, {labelled} labelled pixels against "
             f"{int((won & (plab > 0)).sum())} labelled winner points")
    print(f"[train] (a) train view B={B} N={N} {TH}x{TW} (flip, 7 deg, crop 50/100, fixed "
          f"ColorJitter): K2+K1 == plain fills (features, mask, labels, pt_pix, pt_label, "
          f"pt_won); {int(m.sum())} occupied pixels, {labelled} labelled = labelled winners")


def train_step_run(model, dev, batch, mt_sigma=None, nclasses=20, sensat=False):
    """One train step of `model` on `batch` moved to `dev` (PMFNet and
    EPMFNet: make_pmf_train_step, hybrid optimizer, with `mt_sigma` the
    multi-task loss, σ in the AdamW group, with `sensat` SensatUrban's Dice
    terms and AMSGrad; SalsaNext: its step and adamw), `nclasses` classes,
    class 0 ignored: (aux, gradients by name, BN running statistics)."""
    from pmf_tpu_torch.models import SalsaNext
    from pmf_tpu_torch.train import (HybridOptimizer, LossConfig, adamw, make_pmf_train_step,
                                     make_salsanext_train_step)

    feature, label, points = (t.to(dev) if torch.is_tensor(t) else
                              None if t is None else tuple(x.to(dev) for x in t) for t in batch)
    extra = [] if mt_sigma is None else [torch.nn.Parameter(mt_sigma.to(dev, copy=True))]
    cfg = LossConfig(nclasses=nclasses, alpha=tuple([0.0] + [1.0] * (nclasses - 1)),
                     use_mtloss=bool(extra), use_dice=sensat)
    if isinstance(model, SalsaNext):
        aux = make_salsanext_train_step(model, adamw(model, lambda step: 1e-3), cfg)(feature, label)
    else:
        opt = HybridOptimizer(model, lambda step: 1e-3, 0.9, 1e-5, extra=extra, amsgrad=sensat)
        aux = make_pmf_train_step(model, opt, cfg, *extra)(feature, label, None, points)
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    grads.update({"mt_sigma": p.grad.detach().double().cpu() for p in extra})
    stats = {k: v.detach().cpu() for k, v in model.state_dict().items() if "running" in k}
    return {k: v.cpu() for k, v in aux.items()}, grads, stats


def grad_errors(g_ref, g):
    """‖Δg‖ / ‖g‖ of each parameter, sorted."""
    return sorted(((g[k] - v).norm() / v.norm()).item() for k, v in g_ref.items() if v.norm() > 0)


def check_train_reference(dev):
    """(b): one float32 train step on the card against the CPU at a small
    size (2 scans, 48x96 crop, base 8, dropout 0, the same random weights
    and batch): every loss term within 1e-4 relative and the BN running
    statistics within 1e-5 of each tensor's norm.

    The float32 gradients of this network cannot be held to 1e-3: the
    kinks of ReLU and max pooling make them move with the last bits of the
    forward pass, by percents of a parameter's norm when the batch is
    merely reordered (pmf_tpu's too: tests/test_torch_train.py). In
    float64 they move in the last digits only. So the gradients are
    compared in the same step run in float64 on both devices, each within
    1e-3 of its norm + 1e-7; the float32 ones are printed."""
    from pmf_tpu_torch.data import PVConfig, build_batch
    from pmf_tpu_torch.data.synthetic import make_inputs
    from pmf_tpu_torch.models import PMFNet, random_weights

    h, w = 64, 160
    cfg = PVConfig(canvas_h=h, canvas_w=w + 16, proj_h=h, proj_w=w, proj_ht=48, proj_wt=96,
                   h_pad=2, w_pad=2, n_points=2048)
    raw = make_inputs(np.random.default_rng(8), 2, 2048, h, w)
    f, _, lab, pts = build_batch(*map(torch.from_numpy, raw), cfg, train=True,
                                 aug_override=fixed_aug(2, "cpu", top=4, left=20),
                                 return_points=True)
    model = random_weights(PMFNet(nclasses=20, base_channels=8, dropout_rate=0.0), seed=9)
    hold_train_step(dev, "[train] (b) f32 train step card vs CPU at 2x48x96, base 8",
                    model, (f, lab, pts))


def hold_train_step(dev, tag, model, batch, mt_sigma=None, stats_in_float64=False,
                    nclasses=20, sensat=False):
    """One train step of `model` on `batch` on the card against the CPU,
    held as `check_train_reference` says; with `stats_in_float64` the BN
    statistics are held in the float64 step too (the float32 ones printed)."""
    model64 = copy.deepcopy(model).double()
    model64.dtype = torch.float64
    sigma64 = None if mt_sigma is None else mt_sigma.double()
    cpu = torch.device("cpu")
    run = lambda m, d, sigma: train_step_run(m, d, batch, sigma, nclasses, sensat)
    aux_c, g_c, s_c = run(copy.deepcopy(model), cpu, mt_sigma)
    aux_d, g_d, s_d = run(copy.deepcopy(model).to(dev), dev, mt_sigma)
    _, g64_c, s64_c = run(copy.deepcopy(model64), cpu, sigma64)
    _, g64_d, s64_d = run(copy.deepcopy(model64).to(dev), dev, sigma64)

    loss_err = max(abs(aux_d[k].item() - aux_c[k].item()) / abs(aux_c[k].item())
                   for k in aux_c if k not in ("conf", "conf_cam"))
    stat_diff = lambda a, b: max(((a[k] - b[k]).norm() / b[k].norm()).item() for k in b)
    stat_err, stat_err64 = stat_diff(s_d, s_c), stat_diff(s64_d, s64_c)
    worst_stat = max(s_c, key=lambda k: ((s_d[k] - s_c[k]).norm() / s_c[k].norm()).item())
    held = stat_err64 if stats_in_float64 else stat_err
    if loss_err > 1e-4 or held > 1e-5:
        fail(f"{tag}: losses differ by {loss_err:.3g} relative (tolerance 1e-4), BN "
             f"statistics by {stat_err:.3g} in float32 and {stat_err64:.3g} in float64 "
             f"(tolerance 1e-5{' in float64' if stats_in_float64 else ''})")
    worst = 0.0
    for k, g in g64_c.items():
        err, norm = (g64_d[k] - g).norm().item(), g.norm().item()
        worst = max(worst, err / (1e-3 * norm + 1e-7))
        if err > 1e-3 * norm + 1e-7:
            fail(f"{tag}: float64 gradient {k}: card vs CPU {err:.3g}, norm {norm:.3g}")
    e64, e32 = grad_errors(g64_c, g64_d), grad_errors(g_c, g_d)
    stats = (f"float32 {stat_err:.3g} (at {worst_stat}), float64 {stat_err64:.3g} (tol 1e-5 "
             "in float64)" if stats_in_float64 else f"{stat_err:.3g} (tol 1e-5)")
    print(f"{tag}: losses max rel diff {loss_err:.3g} (tol 1e-4), BN running stats max diff "
          f"of each tensor's norm {stats}; the same step in float64: "
          f"{len(e64)} gradients within 1e-3 of their norm + 1e-7 (the worst at {worst:.3g} "
          f"of that), median |dg|/|g| {e64[len(e64) // 2]:.3g}; the float32 gradients for "
          f"comparison: median |dg|/|g| {e32[len(e32) // 2]:.3g}, max {e32[-1]:.3g}")


def profile_step(step, smi, top: int = 12, name: str = "train step"):
    """torch.profiler over one call of `step` (a trainer step: host batch →
    view → step; or an eval batch): the device's busy time against the
    call's wall time, the PyTorch operations whose own kernels take the
    most device time, and the convolutions that do, by input shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in events
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 reverse=True)
    print(f"[trace] {name}: device busy {busy:.2f} ms of {wall_ms:.2f} ms wall (profiled) "
          f"on {smi}; the operations whose kernels take the most device time:")
    for t, n, k in ops[:top]:
        print(f"[trace]   device {t:9.3f} ms  x{n:<5d} {k}")
    convs = sorted(((e.self_device_time_total / 1e3, e.count, e.key, e.input_shapes)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.device_type == DeviceType.CPU and e.key.startswith("aten::cudnn_conv")),
                   key=lambda c: c[0], reverse=True)
    for t, n, k, shapes in convs[:5]:
        print(f"[trace]   conv   {t:9.3f} ms  x{n:<5d} {k} input, weight {shapes[:2]}")


def scan_reader(raw, n_pool: int, keys=None):
    """reader(i) → the numpy sample dict of synthetic scan i mod n_pool under
    `keys` (by default the perspective views' keys, or the range view's for
    3 arrays)."""
    keys = keys or ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
    return lambda i: {k: a[i % n_pool] for k, a in zip(keys, raw)}


def pmf_train_setup():
    """The full-width PMF Trainer's Options (pmf_kitti.yaml's shapes, bf16,
    batch 8, point Lovász) and its 2 batches of synthetic scans."""
    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data.synthetic import make_inputs

    sensor = {"canvas_h": H, "canvas_w": W + 16, "proj_h": H, "proj_w": W, "proj_ht": TH,
              "proj_wt": TW, "h_pad": 7, "w_pad": 3, "n_points": N}
    opts = Options(config={"sensor": sensor, "augmentation": {"img_jitter": [0.4, 0.4, 0.4]}},
                   compute_dtype="bfloat16", batch_size=(B, B), n_epochs=5, warmup_epochs=1)
    return opts, make_inputs(np.random.default_rng(3), 2 * B, N, H, W)


def full_width_train(dev, smi, timing: dict | None = None):
    """(c): the Trainer at full width; returns the kernels' launch counts
    over its train and validation runs (its ms/step to `timing`)."""
    opts, raw = pmf_train_setup()
    return train_path(dev, smi, "[train] (c)", "PMF-ResNet34", opts, raw, (TH, TW), (H, W),
                      ("rasterize_zbuffer", "zbuffer_keys"), BN_TRAIN_STEP["PMFNet"],
                      timing=timing)


def train_path(dev, smi, tag, net, opts, raw, size_train, size_val, kernels_of_path,
               bn_per_step: int, model=None, keys=None, timing: dict | None = None):
    """The Trainer of `opts` on the in-memory samples `raw` (read under
    `keys`, as `scan_reader` reads them; 2 train batches an epoch, 1
    validation batch): 2 warm-up and 8 timed steps, one
    validation pass, the checks of (6c) (and σ trained, with the
    multi-task loss), a step split by CUDA events and a profiled step.
    It trains `model` (on `dev`), or the net of `opts` with random weights
    from a seed. Returns the kernels' launch counts over the train and
    validation runs; each of `kernels_of_path` must have been launched. The
    three split steps must launch the train-mode epilogue `bn_per_step`
    times each. The ms/step goes to `timing["ms_step"]` when given."""
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.ops import epilogue_train, rasterize, zbuffer
    from pmf_tpu_torch.train import Trainer, pmf_losses, salsanext_losses

    bt, bv = opts.batch_size
    (th, tw), (vh, vw) = size_train, size_val
    reader = scan_reader(raw, 2 * bt, keys)
    if model is None:
        torch.manual_seed(0)
        model = random_weights(build_model(opts), seed=0).to(dev)
    trainer = Trainer(opts, model, reader, 2 * bt, reader, bv, dev,
                      [0.0] + [1.0] * (opts.nclasses - 1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sigma0 = None if trainer.mt_sigma is None else trainer.mt_sigma.detach().clone()

    torch.cuda.reset_peak_memory_stats()
    zbuffer.zbuffer_keys.launches = 0
    rasterize.rasterize_zbuffer.launches = 0
    runs = [trainer.run(0, "Train")]                    # 2 warm-up steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(1, 5):                           # 8 timed steps
        runs.append(trainer.run(epoch, "Train"))
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / 8 * 1e3
    if timing is not None:
        timing["ms_step"] = ms_step
    train_conf = (trainer.metrics.conf.sum(), trainer.metrics_img.conf.sum())
    val = trainer.run(0, "Validation")
    val_conf = (trainer.metrics.conf.sum(), trainer.metrics_img.conf.sum())
    torch.cuda.synchronize()
    launches = {"zbuffer_keys": zbuffer.zbuffer_keys.launches,
                "rasterize_zbuffer": rasterize.rasterize_zbuffer.launches}
    peak = torch.cuda.max_memory_allocated()

    n_terms = 3 if trainer.is_range else 6      # the total and each term
    losses = [v for r in runs + [val] for k, v in r.items() if k.startswith(("loss", "Loss"))]
    if not all(np.isfinite(losses)) or len(losses) != n_terms * len(runs + [val]):
        fail(f"{tag} train path: non-finite or missing losses {runs + [val]}")
    after = model.state_dict()
    params = [k for k, _ in model.named_parameters()]
    stats = [k for k in after if "running" in k]
    moved = sum(not torch.equal(before[k], after[k]) for k in params)
    moved_stats = sum(not torch.equal(before[k], after[k]) for k in stats)
    if moved < len(params) // 2 or moved_stats != len(stats):
        fail(f"{tag} train path: {moved}/{len(params)} parameters and {moved_stats}/"
             f"{len(stats)} BN statistics changed")
    if sigma0 is not None and torch.equal(sigma0, trainer.mt_sigma.detach()):
        fail(f"{tag} the multi-task sigma did not train")
    streams = 1 if trainer.is_range else 2
    if train_conf[:streams] != (2 * bt * th * tw,) * streams or \
            val_conf[:streams] != (bv * vh * vw,) * streams:
        fail(f"{tag} confusion matrices sum to {train_conf} (train) and {val_conf} "
             f"(validation), not the {2 * bt * th * tw} and {bv * vh * vw} labelled pixels")
    if any(launches[k] == 0 for k in kernels_of_path):
        fail(f"{tag} a kernel of the train path was not launched: {launches}")

    # one more step, split by CUDA events (the trainer's pieces, in its order)
    x = {k: torch.from_numpy(a).to(dev) for k, a in next(trainer.batches("Train", 0)).items()}
    g, opt = trainer.generator, trainer.optimizer
    splits = []
    epilogue_train.bn_epilogue.launches = 0
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        f, lab, pts = trainer.view(x, True)
        ev[1].record()
        model.train()
        opt.zero_grad()
        preds = model(f, g) if trainer.is_range else model(f[..., :5], f[..., 5:8], g)
        ev[2].record()
        if trainer.is_range:
            total, _ = salsanext_losses(preds, lab, trainer.loss_cfg)
        else:
            total, _ = pmf_losses(*preds, lab, trainer.loss_cfg, pts, trainer.mt_sigma)
        ev[3].record()
        total.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
    split = [statistics.median(c) for c in zip(*splits)]
    if bn_train_launches() != 3 * bn_per_step:
        fail(f"{tag} the train-mode epilogue ran {bn_train_launches()} times in 3 steps, not "
             f"{3 * bn_per_step}")
    print(f"{tag} train-mode epilogue: {bn_per_step} launches a step")
    names = ("view", "forward", "loss", "backward", "optimizer")
    profile_step(lambda: trainer._step(next(trainer.batches("Train", 0)), True), smi)
    lovasz = "point" if trainer.point_lovasz else "image-domain"
    inputs = f"{raw[0].shape[1]} points" if raw[0].ndim == 3 else \
        f"{raw[0].shape[-2]}x{raw[0].shape[-1]} frames"
    print(f"{tag} Trainer, {net} {opts.compute_dtype}, batch {bt}, {th}x{tw} crop, "
          f"{inputs}, {lovasz} Lovász"
          f"{', multi-task loss' if sigma0 is not None else ''}: "
          f"{ms_step:.2f} ms/step = {bt / ms_step * 1e3:.2f} train scans/s "
          f"(8 steps after 2 warm-up, host-inclusive) on {smi}")
    print(f"{tag} one step split (CUDA events, median of 3): "
          + ", ".join(f"{n} {t:.2f} ms" for n, t in zip(names, split))
          + f" = {sum(split):.2f} ms on {smi}")
    print(f"{tag} peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {smi}")
    sigma = "" if sigma0 is None else \
        f"; sigma {[round(v, 5) for v in trainer.mt_sigma.detach().cpu().tolist()]}"
    print(f"{tag} losses finite; {moved}/{len(params)} parameters and {moved_stats}/"
          f"{len(stats)} BN statistics changed; confusion matrices sum to the labelled pixels "
          f"({train_conf[0]:.0f} train, {val_conf[0]:.0f} validation); last train loss "
          f"{runs[-1]['Loss']:.4f}, validation mIoU {val['IOU']:.4f}{sigma}")
    print(f"{tag} launches on the train path: {json.dumps(launches)}")
    return launches


def epmf_cfg():
    from pmf_tpu_torch.data import V2Config

    return V2Config(canvas_h=H, canvas_w=W + 16, proj_h=HE, proj_w=WE, proj_ht=HE, proj_wt=WE,
                    n_points=NE, img_jitter=(0.4, 0.4, 0.4))


def check_epmf_kernels(dev, cfg, batch, smi):
    """7(a): K2 at the EPMF eval batch's own inputs (its 64-bit keys) and K1
    at one EPMF scan's, each with forced ties, held to the plain versions
    exactly and timed as in phase 3. Returns each kernel's numbers under
    keys prefixed `epmf_`."""
    from pmf_tpu_torch.data.perspective_pipeline_v2 import v2_view_geometry
    from pmf_tpu_torch.ops.scatter import packed_keys

    rows, cols, keep, depth, vals, _ = v2_view_geometry(*batch, cfg)
    rows, cols, depth, keep = force_ties(rows, cols, depth, keep, seed=2, h=HE)
    vals = vals.contiguous()
    err = hold_rasterize("EPMF eval batch, 64-bit keys, forced ties", rows, cols, depth, keep,
                         vals, HE, WE)
    k2 = {"max_abs_err": err, **rasterize_numbers(rows, cols, depth, keep, vals, HE, WE)}
    pix, key, nbits = packed_keys(rows[:1], cols[:1], depth[:1], keep[:1], HE, WE, 1 / 64)
    p1, k1 = pix.contiguous(), key.contiguous()
    err = hold_keys(f"EPMF per-scan path, {nbits} index bits", p1, k1, HE, WE)
    k1_numbers = {"max_abs_err": err, **keys_numbers(p1, k1, HE, WE, int(keep[0].sum()))[0]}
    out = {}
    for name, numbers in (("rasterize_zbuffer", k2), ("zbuffer_keys", k1_numbers)):
        out[name] = {"epmf_" + k: v for k, v in numbers.items()}
        print_numbers(name, out[name], smi, "epmf_")
    return out


def check_epmf_reference(dev):
    """7(b): EPMFNet in float32 on the card against the CPU at 2x64x128,
    base 8, as phase 4 holds PMF (build_v2_batch through the kernels there,
    the plain versions here); then one float32 EPMF train step with the
    multi-task loss and the image-domain Lovász, as 6(b), but with the BN
    statistics held in the float64 step: the deepest BN sees 8 pixels a
    scan at 1/32 resolution, and its float32 variance E[x²] − E[x]²
    cancels, so it moves in the fifth digit with the order of the sums
    (tests/test_torch_epmf_train.py meets the same in pmf_tpu). The scans'
    camera has fx = 60, so that their tight box is about the view's
    size."""
    from pmf_tpu_torch.data import V2AugParams, V2Config, build_v2_batch
    from pmf_tpu_torch.data.synthetic import make_inputs
    from pmf_tpu_torch.losses import init_multi_task_params
    from pmf_tpu_torch.models import EPMFNet, random_weights

    h, w = 64, 128
    cfg = V2Config(canvas_h=h, canvas_w=w + 16, proj_h=h, proj_w=w, proj_ht=h, proj_wt=w,
                   n_points=4096)
    raw = make_inputs(np.random.default_rng(10), 2, 4096, h, w)
    raw[3][:, 0, 1] = raw[3][:, 1, 2] = -60.0
    torch.manual_seed(10)
    model = random_weights(EPMFNet(nclasses=20, base_channels=8), seed=10)
    hold_card_to_cpu(dev, "[epmf] (b)", lambda d: build_v2_batch(*on(raw, d), cfg), model)

    full = lambda v, dt: torch.full((2,), v, dtype=dt)
    aug = V2AugParams(full(1.1, torch.float32), full(True, torch.bool),
                      full(np.deg2rad(7.0), torch.float32), full(4, torch.int64),
                      full(2, torch.int64), fixed_aug(2, "cpu").jitter)
    f, _, lab = build_v2_batch(*map(torch.from_numpy, raw), cfg, train=True, aug_override=aug)
    model = random_weights(EPMFNet(nclasses=20, base_channels=8, dropout_rate=0.0), seed=11)
    sigma = init_multi_task_params(6) * torch.linspace(0.5, 2.0, 6)
    hold_train_step(dev, "[epmf] (b) f32 EPMF train step (multi-task loss) card vs CPU at "
                    "2x64x128, base 8", model, (f, lab, None), sigma, stats_in_float64=True)


def check_tight_box(batch, cfg):
    """The EPMF scans' tight box (the kept points' truncated pixels) against
    the view: the box must be larger, so the eval view is a centre crop."""
    from pmf_tpu_torch.ops.projection import yaw_crop_project

    points, _, valid, proj = batch[:4]
    rows, cols, keep = yaw_crop_project(points[..., :3], proj, cfg.fov_left, cfg.fov_right, valid)
    extent = lambda v: (torch.where(keep, v.trunc(), -1e30).amax(1)
                        - torch.where(keep, v.trunc(), 1e30).amin(1) + 1)
    h, w = extent(rows), extent(cols)
    if not ((h > cfg.proj_h) | (w > cfg.proj_w)).all():
        fail(f"the EPMF scans' tight boxes ({h.tolist()} x {w.tolist()}) fit the view: no crop")
    print(f"[epmf] tight box of the kept points: {int(h.min())}-{int(h.max())} x "
          f"{int(w.min())}-{int(w.max())} px, {int(keep.sum(1).min())}-{int(keep.sum(1).max())} "
          f"points kept of {points.shape[1]}: centre-cropped to {cfg.proj_h}x{cfg.proj_w}")


def epmf_main_path(dev, cfg, batch, raw, smi):
    """7(c): batched EPMF-ResNet34 eval and one scan of Inference.run's EPMF
    branch, as phase 5."""
    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data import build_v2_batch
    from pmf_tpu_torch.data.perspective_pipeline_v2 import _build_v2_batch
    from pmf_tpu_torch.models import EPMFNet, random_weights

    torch.manual_seed(0)
    model = random_weights(EPMFNet(nclasses=20, base_channels=32, image_backbone="resnet34",
                                   dtype=torch.bfloat16), seed=0).to(dev)
    pv = {"canvas_h": cfg.canvas_h, "canvas_w": cfg.canvas_w, "proj_h": HE, "proj_w": WE,
          "n_points": NE}
    opts = Options(net_type="EPMFNet", nclasses=20, base_channels=32, compute_dtype="bfloat16",
                   config={"PVconfig": pv, "post": {"KNN": {"params": {
                       "knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}}})
    return eval_path(dev, "[epmf] (c)", "build_v2_batch+EPMFNet+argmax", model, opts,
                     build_v2_batch, _build_v2_batch, cfg, batch, raw, (HE, WE), smi,
                     aspp_per_call=2, epilogue_per_call=EPILOGUES["EPMFNet"])


def epmf_train_setup():
    """The full-width EPMF Trainer's Options (epmf_kitti.yaml: bf16, batch 2
    for training and 4 for validation, multi-task loss, image-domain
    Lovász) and its 2 batches of synthetic scans."""
    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data.synthetic import make_inputs

    pv = {"canvas_h": H, "canvas_w": W + 16, "proj_h": HE, "proj_w": WE, "proj_ht": HE,
          "proj_wt": WE, "n_points": NE}
    opts = Options(config={"PVconfig": pv, "augmentation": {"img_jitter": [0.4, 0.4, 0.4]},
                           "use_mtloss": True, "point_lovasz": False},
                   net_type="EPMFNet", compute_dtype="bfloat16", batch_size=(BT, BV),
                   n_epochs=5, warmup_epochs=1)
    return opts, make_inputs(np.random.default_rng(4), 2 * BT, NE, H, W)


def epmf_train(dev, smi):
    """7(d): the EPMF Trainer at full width (`epmf_train_setup`)."""
    opts, raw = epmf_train_setup()
    return train_path(dev, smi, "[epmf] (d)", "EPMF-ResNet34", opts, raw, (HE, WE), (HE, WE),
                      ("rasterize_zbuffer",), BN_TRAIN_STEP["EPMFNet"])


def salsanext_opts():
    """Options of configs/experiments/salsanext_kitti.yaml as shipped (the
    file's values, written out: this script reads no YAML)."""
    from pmf_tpu_torch.config import Options

    aug = {"p_flipx": 0.0, "p_flipy": 0.5, "p_transx": 0.5, "trans_xmin": -5, "trans_xmax": 5,
           "p_transy": 0.5, "trans_ymin": -3, "trans_ymax": 3, "p_transz": 0.5,
           "trans_zmin": -1, "trans_zmax": 0.0, "p_rot_roll": 0.5, "rot_rollmin": -5,
           "rot_rollmax": 5, "p_rot_pitch": 0.5, "rot_pitchmin": -5, "rot_pitchmax": 5,
           "p_rot_yaw": 0.5, "rot_yawmin": 5, "rot_yawmax": -5}
    sensor = {"proj_h": RH, "proj_w": RW, "fov_up": 3.0, "fov_down": -25.0, "fov_left": -180.0,
              "fov_right": 180.0, "n_points": RN}
    return Options(config={"sensor": sensor, "augmentation": aug, "post": {"KNN": {"params": {
        "knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}}},
        net_type="SalsaNext", nclasses=20, base_channels=32, lr=0.01, batch_size=(RB, RB),
        n_epochs=5, warmup_epochs=1, lambda_=1.0, gamma=0.0)


def check_range_kernels(dev, batch, smi):
    """8(a): K1 at the SalsaNext range batch's own keys (8 scans of 131072
    points into 64x2048, 17 index bits) with forced ties, held to its plain
    version exactly and timed as in phase 3. Returns its numbers under keys
    prefixed `range_`."""
    from pmf_tpu_torch.data import range_config
    from pmf_tpu_torch.ops import zbuffer
    from pmf_tpu_torch.ops.projection import spherical_project
    from pmf_tpu_torch.ops.scatter import packed_keys

    cfg = range_config(salsanext_opts())
    px, py, depth, keep = spherical_project(batch[0], cfg.fov_up, cfg.fov_down, RH, RW,
                                            cfg.fov_left, cfg.fov_right, batch[2])
    py, px, depth, keep = force_ties(py, px, depth, keep, seed=3, h=RH)
    pix, key, nbits = packed_keys(py, px, depth, keep, RH, RW, 1 / 64)
    pix, key = pix.contiguous(), key.contiguous()
    err = hold_keys(f"SalsaNext range batch, {nbits} index bits, forced ties", pix, key, RH, RW)
    numbers = {"max_abs_err": err, **keys_numbers(pix, key, RH, RW, int(keep.sum()))[0]}
    out = {"range_" + k: v for k, v in numbers.items()}
    print_numbers("zbuffer_keys", out, smi, "range_")
    trace("zbuffer_keys at the range batch", lambda: zbuffer.zbuffer_keys(pix, key, RH, RW), smi)
    return out


def range_view(build, raw, cfg, **kw):
    """`build` (the batched range view) on device tensors of `raw` as the
    perspective views return theirs: (features, mask, labels)."""
    f, lab, mask = build(*raw, cfg, **kw)
    return f, mask, lab


def check_salsanext_reference(dev):
    """8(b): SalsaNext in float32 on the card against the CPU at 2x16x128,
    base 8, as phase 4 holds PMF (build_range_batch through K1 there, the
    plain version here); then one float32 SalsaNext train step (adamw) on
    the card against the CPU, as 6(b), with its BN statistics held in the
    float64 step as 7(b) does: the deepest BN sees 8 pixels a scan."""
    from pmf_tpu_torch.data import RangeConfig, build_range_batch
    from pmf_tpu_torch.data.synthetic import make_range_inputs
    from pmf_tpu_torch.models import SalsaNext, random_weights

    cfg = RangeConfig(proj_h=16, proj_w=128, n_points=4096)
    raw = make_range_inputs(np.random.default_rng(12), 2, 4096, 4000)
    torch.manual_seed(12)
    model = random_weights(SalsaNext(nclasses=20, base_channels=8), seed=12)
    hold_card_to_cpu(dev, "[salsanext] (b)",
                     lambda d: range_view(build_range_batch, on(raw, d), cfg), model,
                     lambda m, f: (m(f),))
    f, lab, _ = build_range_batch(*on(raw, "cpu"), cfg)
    model = random_weights(SalsaNext(nclasses=20, base_channels=8, dropout_rate=0.0), seed=13)
    hold_train_step(dev, "[salsanext] (b) f32 SalsaNext train step card vs CPU at 2x16x128, "
                    "base 8", model, (f, lab, None), stats_in_float64=True)


def salsanext_main_path(dev, batch, raw, smi):
    """8(c): batched SalsaNext eval at full width (base 32, float32, batch
    8): build_range_batch → SalsaNext → argmax, the kernel fill equal to
    the plain fill, and one scan through SalsaNextInference.run with KNN;
    K1's launches read around this phase alone; scans/s. Returns the
    launch counts."""
    from pmf_tpu_torch.data import build_range_batch, range_config
    from pmf_tpu_torch.data.range_pipeline import _build_range_batch
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.ops import argmax_last, zbuffer
    from pmf_tpu_torch.tools.infer_salsanext import SalsaNextInference

    opts = salsanext_opts()
    cfg = range_config(opts)
    torch.manual_seed(0)
    model = random_weights(build_model(opts), seed=0).to(dev)
    scan = {k: a[0] for k, a in zip(("points", "labels", "valid"), raw)}
    inference = SalsaNextInference(opts, model, lambda i: scan, 1, dev, use_knn=True)

    def batched():
        f, lab, m = build_range_batch(*batch, cfg)
        pred = model(f)
        return f, m, lab, pred, argmax_last(pred)

    reset_launches()
    with torch.inference_mode():
        f, m, lab, pred, am = batched()
        report = inference.run()
    launches = read_launches()
    print(f"[salsanext] (c) launches on the SalsaNext eval path: {json.dumps(launches)}")
    if launches["zbuffer_keys"] == 0 or launches["conv_epilogue"]:
        fail(f"[salsanext] (c) K1 was not launched on the SalsaNext eval path, or the conv "
             f"epilogue was in float32: {launches}")
    model.dtype = torch.bfloat16          # the same net in bf16: one launch a conv
    reset_launches()
    with torch.inference_mode():
        pred16 = model(f)
    bf16 = read_launches()["conv_epilogue"]
    model.dtype = torch.float32
    if bf16 != EPILOGUES["SalsaNext"] or not torch.isfinite(pred16).all():
        fail(f"[salsanext] (c) a bf16 SalsaNext forward launched the conv epilogue {bf16} "
             f"times, not {EPILOGUES['SalsaNext']}, or its probabilities are not finite")
    print(f"[salsanext] (c) one bf16 forward of the batch: {bf16} conv epilogue launches; "
          f"argmax agrees with float32's at {float((argmax_last(pred16) == am).double().mean()):.4f} "
          "of the pixels")
    del pred16
    if pred.shape != (RB, RH, RW, 20) or not torch.isfinite(pred).all() \
            or not torch.isfinite(f).all() or f.shape != (RB, RH, RW, 5):
        fail(f"[salsanext] (c) probabilities {tuple(pred.shape)} or features "
             f"{tuple(f.shape)} of the wrong shape or not finite")
    n_classes = am.unique().numel()
    if n_classes < 2 or int(lab.min()) < 0 or int(lab.max()) >= 20:
        fail(f"[salsanext] (c) {n_classes} classes predicted, labels "
             f"{int(lab.min())}..{int(lab.max())}")
    if not all(np.isfinite(report[k]) for k in ("mIoU", "mAcc", "mRecall")):
        fail(f"[salsanext] (c) SalsaNextInference.run report is not finite: {report}")
    print(f"[salsanext] (c) batched: {int(m.sum())} occupied pixels, {n_classes} classes "
          f"predicted; one scan through SalsaNextInference.run (KNN): point mIoU "
          f"{report['mIoU']:.4f}")

    with torch.inference_mode():
        plain = _build_range_batch(*batch, cfg, keys=zbuffer.zbuffer_keys_plain)
        if not all(torch.equal(x, y) for x, y in zip((f, lab, m), plain)):
            fail("[salsanext] (c) the batched range view gives other features, labels or "
                 "mask with the plain fill")
        print("[salsanext] (c) batched range view: K1 fill == plain fill (features, labels, "
              "mask)")
        for _ in range(2):
            batched()
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        profile_step(batched, smi, name="eval batch (build_range_batch+SalsaNext+argmax)")
    med = statistics.median(times)
    print(f"[salsanext] (c) batched eval build_range_batch+SalsaNext+argmax, batch {RB}, "
          f"{RH}x{RW}, {RN} points, float32 (TF32 off): {RB / med:.2f} scans/s (median of "
          f"{len(times)} batches: {med * 1e3:.2f} ms, min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}) on {smi}")
    return launches


def salsanext_train(dev, smi):
    """8(d): the SalsaNext Trainer at full width (salsanext_kitti.yaml:
    float32, batch 8 for training and validation, 64x2048, 131072 points,
    the point augmentation with its reversed yaw bounds)."""
    from pmf_tpu_torch.data.synthetic import make_range_inputs

    raw = make_range_inputs(np.random.default_rng(5), 2 * RB, RN, RN - 10000)
    return train_path(dev, smi, "[salsanext] (d)", "SalsaNext", salsanext_opts(), raw,
                      (RH, RW), (RH, RW), ("zbuffer_keys",), 0)


def nusc_opts(net: str, **kw):
    """Options of configs/experiments/{pmf,epmf,salsanext}_nuscenes.yaml as
    shipped, the groups the port reads written out (this script reads no
    YAML): base 32, 17 classes."""
    from pmf_tpu_torch.config import Options

    mean, stds = [12.12, 10.88, 0.23, -1.04, 0.21], [12.32, 11.47, 6.91, 0.86, 0.16]
    knn = {"KNN": {"params": {"knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}}
    aug = {"p_flipx": 0.0, "p_flipy": 0.5, "p_transx": 0.5, "trans_xmin": -5, "trans_xmax": 5,
           "p_transy": 0.5, "trans_ymin": -3, "trans_ymax": 3, "p_transz": 0.5,
           "trans_zmin": -1, "trans_zmax": 0.0, "p_rot_roll": 0.5, "rot_rollmin": -5,
           "rot_rollmax": 5, "p_rot_pitch": 0.5, "rot_pitchmin": -5, "rot_pitchmax": 5,
           "p_rot_yaw": 0.5, "rot_yawmin": 5, "rot_yawmax": -5}
    if net == "PMFNet":
        config = {"sensor": {"canvas_h": NCH, "canvas_w": NCW, "proj_h": NH, "proj_w": NW,
                             "proj_ht": NTH, "proj_wt": NTW, "h_pad": 0, "w_pad": 0,
                             "n_points": NN, "pcd_aug": False, "img_mean": mean,
                             "img_stds": stds},
                  "augmentation": dict(aug, img_jitter=[0.4, 0.4, 0.4])}
        opts = dict(batch_size=(NBT, NBV), compute_dtype="bfloat16")
    elif net == "EPMFNet":
        config = {"PVconfig": {"canvas_h": NCH, "canvas_w": NCW, "proj_h": EH, "proj_w": EW,
                               "proj_ht": ETH, "proj_wt": ETW, "n_points": NN,
                               "img_jitter": [0.4, 0.4, 0.4],
                               "pcd_mean": [12.87, 0.01, 0.44, 11.97, 19.07],
                               "pcd_stds": [13.21, 6.05, 1.96, 12.5, 21.23]},
                  "augmentation": dict(aug, img_jitter=[0.4, 0.4, 0.4]),
                  "use_mtloss": True, "point_lovasz": False}
        opts = dict(batch_size=(EBT, 10), compute_dtype="bfloat16")
    else:
        config = {"sensor": {"proj_h": SH, "proj_w": SW, "fov_up": 10.0, "fov_down": -30.0,
                             "fov_left": -180.0, "fov_right": 180.0, "n_points": NN,
                             "img_mean": mean, "img_stds": stds}, "augmentation": aug}
        opts = dict(batch_size=(12, 12), gamma=0.0)
    config["post"] = knn
    return Options(config=config, dataset="nuScenes", net_type=net, nclasses=17,
                   base_channels=32, **{**opts, **kw})


def items_reader(raw):
    """reader(i) → the numpy sample dict of item i of `raw` (the arrays of
    `make_nuscenes_inputs`), as `nuscenes_sample_reader` gives it."""
    keys = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
    return lambda i: {k: a[i] for k, a in zip(keys, raw)}


def check_nuscenes_kernels(dev, batch, smi):
    """9(a): K2 at the PMF nuScenes train view's own inputs (3 items of
    65536 points into 640x960, F=6: 64-bit keys) and K1 on one eval item
    (65536 points into 896x1600: 16 index bits, depth clipped at 512 m), each
    with forced ties, held to its plain version exactly and timed as in
    phase 3 (`nusc_` keys); then the train view's winner flags (K1) against
    K2's mask and labels at that batch."""
    from pmf_tpu_torch.data import build_batch, pv_config
    from pmf_tpu_torch.data.perspective_pipeline import view_geometry
    from pmf_tpu_torch.ops.scatter import packed_keys

    cfg = pv_config(nusc_opts("PMFNet"))
    train3 = [t[:NBT] for t in batch]
    aug = fixed_aug(NBT, dev, top=(NCH - NTH) // 3, left=(NCW - NTW) // 3)._replace(jitter=None)
    rows, cols, keep, depth, vals, _ = view_geometry(*train3, cfg, aug)
    rows, cols, depth, keep = force_ties(rows, cols, depth, keep, seed=4, h=NTH)
    vals = vals.contiguous()
    err = hold_rasterize("nuScenes PMF train view, 64-bit keys, forced ties", rows, cols, depth,
                         keep, vals, NTH, NTW)
    k2 = {"max_abs_err": err, **rasterize_numbers(rows, cols, depth, keep, vals, NTH, NTW)}

    rows, cols, keep, depth, _, _ = view_geometry(*(t[:1] for t in batch), cfg)
    rows, cols, depth, keep = force_ties(rows, cols, depth, keep, seed=5, h=NH)
    pix, key, nbits = packed_keys(rows, cols, depth, keep, NH, NW, 1 / 64)
    p1, k1 = pix.contiguous(), key.contiguous()
    err = hold_keys(f"nuScenes PMF eval item, {nbits} index bits", p1, k1, NH, NW)
    k1_numbers = {"max_abs_err": err, **keys_numbers(p1, k1, NH, NW, int(keep.sum()))[0]}
    out = {}
    for name, numbers in (("rasterize_zbuffer", k2), ("zbuffer_keys", k1_numbers)):
        out[name] = {"nusc_" + k: v for k, v in numbers.items()}
        print_numbers(name, out[name], smi, "nusc_")

    with torch.no_grad():
        _, mask, lab, (pix, plab, won) = build_batch(*train3, cfg, True, aug_override=aug,
                                                     return_points=True)
    hw = NTH * NTW
    win_pix = torch.where(won, pix.long(), hw)
    hit = torch.zeros((NBT, hw + 1), dtype=torch.bool, device=dev).scatter_(1, win_pix, True)
    lab_at = torch.cat([lab.reshape(NBT, -1), lab.new_zeros((NBT, 1))], 1).gather(1, win_pix)
    if not (torch.equal(hit[:, :hw].reshape(mask.shape), mask)
            and torch.equal(lab_at[won], plab[won])):
        fail("[nusc] (a) the point Lovász's winner flags (K1) disagree with K2's mask or labels")
    far = float(train3[0][..., :3].norm(dim=-1).max())
    print(f"[nusc] (a) train view B={NBT} N={NN} {NTH}x{NTW}: K1's winner flags pick one point "
          f"per K2 pixel, with its label ({int(mask.sum())} pixels; ranges <= {far:.1f} m, "
          "inside K1's 512 m clip)")
    return out


def check_nuscenes_reference(dev):
    """9(b): a small PMFNet (17 classes, base 8) on the "cam" view and a
    small EPMFNet on the camera-frame V2 view with each camera's fovs, in
    float32 on the card against the CPU as phase 4 holds them; then one
    float32 PMF nuScenes train step (point Lovász) as 6(b)."""
    from pmf_tpu_torch.data import PVConfig, V2Config, build_batch, build_v2_batch
    from pmf_tpu_torch.data.synthetic import make_nuscenes_inputs, nuscenes_camera_frame
    from pmf_tpu_torch.models import EPMFNet, PMFNet, random_weights

    h, w = 64, 160
    raw = make_nuscenes_inputs(np.random.default_rng(14), 1, 4096, 3000, h, w)
    two = [a[:2] for a in raw]
    cfg = PVConfig(canvas_h=h, canvas_w=w, proj_h=h, proj_w=128, proj_ht=48, proj_wt=96,
                   h_pad=0, w_pad=0, n_points=4096, projection="cam")
    torch.manual_seed(14)
    model = random_weights(PMFNet(nclasses=17, base_channels=8), seed=14)
    hold_card_to_cpu(dev, "[nusc] (b) PMF \"cam\" view", lambda d: build_batch(*on(two, d), cfg),
                     model)

    points, proj, fovs = nuscenes_camera_frame(raw[0], h, w)
    v2 = [points[2:4], raw[1][2:4], raw[2][2:4], proj[2:4], *(a[2:4] for a in raw[4:])]
    cfg_v2 = V2Config(canvas_h=h, canvas_w=w, proj_h=h, proj_w=128, n_points=4096,
                      cam_frame=True)
    model = random_weights(EPMFNet(nclasses=17, base_channels=8), seed=15)
    hold_card_to_cpu(dev, "[nusc] (b) EPMF camera-frame V2 view with fovs",
                     lambda d: build_v2_batch(*on(v2, d), cfg_v2,
                                              fovs=torch.from_numpy(fovs[2:4]).to(d)), model)

    f, _, lab, pts = build_batch(*map(torch.from_numpy, two), cfg, train=True,
                                 aug_override=fixed_aug(2, "cpu", top=4, left=20),
                                 return_points=True)
    model = random_weights(PMFNet(nclasses=17, base_channels=8, dropout_rate=0.0), seed=16)
    hold_train_step(dev, "[nusc] (b) f32 PMF nuScenes train step card vs CPU at 2x48x96, base 8",
                    model, (f, lab, pts), nclasses=17)


def nusc_model(net: str, dev):
    """The net of its nuScenes config (`nusc_opts`) with random weights from
    a seed, on `dev`."""
    from pmf_tpu_torch.models import build_model, random_weights

    torch.manual_seed(0)
    return random_weights(build_model(nusc_opts(net)), seed=0).to(dev)


def hold_item_keys(inference, raw, tag: str):
    """K1 on the keys of each item of `raw`'s first keyframe at
    `inference`'s eval view (a `NuscenesInference`: PMF's "cam" view or
    EPMF's V2 view), held to its plain version bit for bit."""
    from pmf_tpu_torch.data.perspective_pipeline import scan_sizes, view_geometry
    from pmf_tpu_torch.data.perspective_pipeline_v2 import v2_view_geometry
    from pmf_tpu_torch.ops.scatter import packed_keys

    cfg, dev = inference.cfg, inference.device
    geometry = v2_view_geometry if inference.is_v2 else view_geometry
    for i in range(6):
        s = items_reader(raw)(i)
        one = lambda k: torch.as_tensor(s[k], device=dev)[None]
        rows, cols, keep, depth, _, _ = geometry(
            one("points"), one("labels"), one("valid"), one("proj_matrix"), one("image"),
            *scan_sizes(int(s["img_h"]), int(s["img_w"]), dev), cfg)
        pix, key, nbits = packed_keys(rows, cols, depth, keep, cfg.proj_h, cfg.proj_w, 1 / 64)
        hold_keys(f"{tag} NuscenesInference item {i}, {nbits} index bits, {int(keep.sum())} "
                  "points kept", pix.contiguous(), key.contiguous(), cfg.proj_h, cfg.proj_w)


def nuscenes_inference(dev, model, net: str, raw, smi, tag: str):
    """`NuscenesInference.run` of `model` (a `net` at the full width of its
    nuScenes config, KNN on) over the keyframes of `raw`, the kernels'
    launches counted around it alone; ms/keyframe, the merged coverage, a
    profiled keyframe's device busy time; then K1 held on the first
    keyframe's items (`hold_item_keys`). Returns the launch counts."""
    from pmf_tpu_torch.tools.infer_nuscenes import NuscenesInference

    opts = nusc_opts(net)
    n = len(raw[0])
    make = lambda k: NuscenesInference(opts, model, items_reader(raw), k, dev,
                                       [f"frame{i // 6}" for i in range(n)], use_knn=True)
    captures, replays = graph_counts(model)
    reset_launches()
    with torch.inference_mode():
        make(6).run()                                     # warm-up keyframe
    torch.cuda.synchronize()
    report = make(n).run()
    launches = read_launches()
    items = 6 + n
    per_item = 2 if net == "EPMFNet" else 1    # ASPPs a forward, one forward an item
    # the net's kernels launch from Python in the first item's eager forward
    # and in the second's warm-up and capture; every later item replays the
    # net's CUDA graphs (models/graphs.py), the second included
    if launches["zbuffer_keys"] != items or report["frames"] != n // 6 \
            or launches["aspp_branches"] != 3 * per_item \
            or launches["conv_epilogue"] != 3 * EPILOGUES[net] \
            or graph_counts(model) != (captures + 1, replays + items - 1):
        fail(f"{tag} NuscenesInference ran {report['frames']} keyframes after a warm-up one "
             f"with K1 launched {launches['zbuffer_keys']} times, the ASPP kernel "
             f"{launches['aspp_branches']} times, the conv epilogue "
             f"{launches['conv_epilogue']} times and the net's graphs captured and replayed "
             f"{tuple(a - b for a, b in zip(graph_counts(model), (captures, replays)))} times "
             f"for {items} items")
    if not (np.isfinite(report["mIoU"]) and 0 < report["coverage"] < 1):
        fail(f"{tag} NuscenesInference report: {report}")
    hold_item_keys(make(6), raw, tag)
    profile_step(lambda: make(6).run(), smi, name=f"one keyframe of NuscenesInference.run ({net})")
    print(f"{tag} NuscenesInference.run ({net}, bf16, KNN, 6 cameras of {NN} points): "
          f"{report['ms_per_frame']:.2f} ms/keyframe over {report['frames']} keyframes (host and "
          f"device, after one warm-up keyframe); merged coverage {report['coverage']:.4f} of the "
          f"points; point mIoU {report['mIoU']:.4f}; launches {json.dumps(launches)} on {smi}")
    return launches


def nuscenes_batched_eval(dev, model, raw, smi):
    """9(c), second part: the batched validation view of PMF nuScenes
    (build_batch "cam" → K2 → `model`, PMFNet → argmax) at batch 4, against
    the same with the plain fill; scans/s. Returns the launch counts."""
    from pmf_tpu_torch.data import build_batch, pv_config
    from pmf_tpu_torch.data.perspective_pipeline import _build_batch
    from pmf_tpu_torch.ops import argmax_last, rasterize

    cfg = pv_config(nusc_opts("PMFNet"))
    batch = on([a[:NBV] for a in raw], dev)

    def batched():
        f, m, lab = build_batch(*batch, cfg)
        lidar, _ = model(f[..., :5], f[..., 5:8])
        return f, m, lab, lidar, argmax_last(lidar)

    reset_launches()
    with torch.inference_mode():
        f, m, lab, lidar, pred = batched()
        launches = read_launches()
        if launches["rasterize_zbuffer"] == 0 or launches["aspp_branches"] != 1 \
                or launches["conv_epilogue"] != EPILOGUES["PMFNet"]:
            fail(f"[nusc] (c) K2 was not launched on the batched view, or the ASPP kernel "
                 f"not once, or the conv epilogue not once a conv: {launches}")
        if lidar.shape != (NBV, NH, NW, 17) or not torch.isfinite(lidar).all() \
                or pred.unique().numel() < 2:
            fail(f"[nusc] (c) batched probabilities {tuple(lidar.shape)}, finite "
                 f"{bool(torch.isfinite(lidar).all())}, {pred.unique().numel()} classes")
        plain = _build_batch(*batch, cfg, fill=rasterize.rasterize_zbuffer_plain)
        if not all(torch.equal(x, y) for x, y in zip((f, m, lab), plain)):
            fail("[nusc] (c) the batched view gives other features, mask or labels with the "
                 "plain fill")
        for _ in range(2):
            batched()
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        profile_step(batched, smi, name="eval batch (nuScenes build_batch+PMFNet+argmax)")
    med = statistics.median(times)
    print(f"[nusc] (c) batched eval build_batch(\"cam\")+PMFNet+argmax, batch {NBV}, {NH}x{NW}, "
          f"{NN} points, bf16: kernel fill == plain fill; {int(m.sum())} occupied pixels; "
          f"{NBV / med:.2f} scans/s (median of {len(times)} batches: {med * 1e3:.2f} ms, min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) on {smi}")
    return launches


def nuscenes_r50_item(dev, raw, smi):
    """9(c), third part: PMF-ResNet50 (pmf_nuscenes.yaml with img_backbone
    resnet50, the net of the keyframe cell) in bf16 on one item's "cam" view
    at 896x1600: one conv epilogue launch a conv (122) and one ASPP launch,
    the probabilities finite; ms a forward. Returns the launch counts."""
    from pmf_tpu_torch.data import build_batch, pv_config
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.ops import argmax_last

    opts = nusc_opts("PMFNet", img_backbone="resnet50")
    torch.manual_seed(0)
    model = random_weights(build_model(opts), seed=0).to(dev)
    with torch.inference_mode():
        f, _, _ = build_batch(*on([a[:1] for a in raw], dev), pv_config(opts))
        forward = lambda: model(f[..., :5], f[..., 5:8])
        reset_launches()
        lidar, _ = forward()                               # eager
        launches = read_launches()
        captures, replays = graph_counts(model)
        reset_launches()
        forward()                        # warm-up and capture of the CUDA graphs, a replay
        captured = read_launches()
        ms = ms_per_call(forward)                          # replays
        replayed = read_launches()
    n_classes = argmax_last(lidar).unique().numel()
    if launches["conv_epilogue"] != EPILOGUES["PMFNet-ResNet50"] \
            or launches["aspp_branches"] != 1 or lidar.shape != (1, NH, NW, 17) \
            or not torch.isfinite(lidar).all() or n_classes < 2:
        fail(f"[nusc] (c) PMF-ResNet50 on one item: probabilities {tuple(lidar.shape)}, finite "
             f"{bool(torch.isfinite(lidar).all())}, {n_classes} classes; launches {launches}")
    if captured["conv_epilogue"] != 2 * EPILOGUES["PMFNet-ResNet50"] \
            or captured["aspp_branches"] != 2 or replayed != captured \
            or graph_counts(model)[0] != captures + 1:
        fail(f"[nusc] (c) PMF-ResNet50's second call on one item launched {captured} (its "
             f"warm-up and capture), the replays after it {replayed}")
    print(f"[nusc] (c) PMF-ResNet50 on one item at {NH}x{NW}, bf16: {n_classes} classes "
          f"predicted, {ms:.2f} ms a forward; launches {json.dumps(launches)} on {smi}")
    return launches


def epmf_nuscenes_train_step(dev, model, raw, smi):
    """9(e): the EPMF nuScenes Trainer of `model` at epmf_nuscenes.yaml's
    batch 6, 320x1088 (multi-task loss, image-domain Lovász): one warm-up and
    one timed step, the kernels' launches counted around the timed step
    alone, finite losses, the peak memory; then K2 held to its plain version
    on the train view of the first EPMF batch with the trainer's draws.
    Returns the launch counts."""
    from pmf_tpu_torch.data import v2_config
    from pmf_tpu_torch.data.perspective_pipeline_v2 import v2_view_geometry
    from pmf_tpu_torch.ops import rasterize, zbuffer
    from pmf_tpu_torch.train import Trainer, nuscenes_focal_alpha

    opts = nusc_opts("EPMFNet", n_epochs=5, warmup_epochs=1)
    trainer = Trainer(opts, model, items_reader(raw), EBT, items_reader(raw), EBT, dev,
                      nuscenes_focal_alpha(17))
    torch.cuda.reset_peak_memory_stats()
    runs = [trainer.run(0, "Train")]
    torch.cuda.synchronize()
    zbuffer.zbuffer_keys.launches = 0
    rasterize.rasterize_zbuffer.launches = 0
    t0 = time.perf_counter()
    runs.append(trainer.run(1, "Train"))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"zbuffer_keys": zbuffer.zbuffer_keys.launches,
                "rasterize_zbuffer": rasterize.rasterize_zbuffer.launches}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(v) for r in runs for k, v in r.items() if k.startswith("loss")):
        fail(f"[nusc] (e) EPMF train step: non-finite losses {runs}")
    if launches["rasterize_zbuffer"] == 0:
        fail(f"[nusc] (e) K2 was not launched on the EPMF train step: {launches}")
    rows, cols, keep, depth, vals, _ = v2_view_geometry(
        *on([a[:EBT] for a in raw], dev), v2_config(opts), train=True,
        generator=torch.Generator(device=dev).manual_seed(opts.seed))
    hold_rasterize(f"[nusc] (e) EPMF train view with the trainer's draws, 64-bit keys, "
                   f"{int(keep.sum())} points kept", rows, cols, depth, keep, vals.contiguous(),
                   ETH, ETW)
    print(f"[nusc] (e) EPMF nuScenes Trainer, bf16, batch {EBT}, {ETH}x{ETW} crop, {NN} points, "
          f"multi-task loss: one step {ms:.2f} ms (after one warm-up step, host-inclusive); "
          f"peak device memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); last "
          f"loss {runs[-1]['Loss']:.4f}; launches {json.dumps(launches)} on {smi}")
    return launches


def salsanext_nuscenes_scan(dev, raw, smi):
    """9(e): one scan through SalsaNextInference's nuScenes branch at
    salsanext_nuscenes.yaml's 32x2048, fov +10/-30 (float32, KNN); then K1
    held to its plain version on that scan's keys (65536 points into 65536
    pixels). Returns the launch counts."""
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.ops.projection import spherical_project
    from pmf_tpu_torch.ops.scatter import packed_keys
    from pmf_tpu_torch.tools.infer_salsanext import SalsaNextInference

    opts = nusc_opts("SalsaNext")
    torch.manual_seed(0)
    model = random_weights(build_model(opts), seed=0).to(dev)
    scan = {k: a[0] for k, a in zip(("points", "labels", "valid"), raw)}
    inference = SalsaNextInference(opts, model, lambda i: scan, 1, dev, use_knn=True)
    inference.run()                                       # warm-up
    inference = SalsaNextInference(opts, model, lambda i: scan, 1, dev, use_knn=True)
    reset_launches()
    report = inference.run()
    launches = read_launches()
    if launches["zbuffer_keys"] != 1 or launches["conv_epilogue"] \
            or not np.isfinite(report["mIoU"]):
        fail(f"[nusc] (e) SalsaNextInference on nuScenes: {report}, launches {launches}")
    cfg = inference.cfg
    one = [torch.as_tensor(scan[k], device=dev)[None] for k in ("points", "valid")]
    px, py, depth, keep = spherical_project(one[0], cfg.fov_up, cfg.fov_down, cfg.proj_h,
                                            cfg.proj_w, cfg.fov_left, cfg.fov_right, one[1])
    pix, key, nbits = packed_keys(py, px, depth, keep, cfg.proj_h, cfg.proj_w, 1 / 64)
    hold_keys(f"[nusc] (e) SalsaNextInference scan, {nbits} index bits, {int(keep.sum())} points "
              "kept", pix.contiguous(), key.contiguous(), cfg.proj_h, cfg.proj_w)
    print(f"[nusc] (e) SalsaNextInference.run, nuScenes {SH}x{SW} fov +10/-30, float32, KNN: "
          f"point mIoU {report['mIoU']:.4f}, {report['ms_per_scan']:.2f} ms/scan (forward to "
          f"labels); launches {json.dumps(launches)} on {smi}")
    return launches


def nuscenes_phase(dev, smi):
    """Phase 9: nuScenes. Returns the kernels' nuScenes numbers and launch
    counts, by kernel name; prints the time of each part."""
    from pmf_tpu_torch.data.synthetic import make_nuscenes_inputs

    marks = [("", time.perf_counter())]
    raw = make_nuscenes_inputs(np.random.default_rng(9), 2, NN, 34720 * NN // 65536, NCH, NCW)
    frame = [a[:6] for a in raw]
    marks.append(("data", time.perf_counter()))
    out = check_nuscenes_kernels(dev, on(frame, dev), smi)
    marks.append(("(a)", time.perf_counter()))
    check_nuscenes_reference(dev)
    marks.append(("(b)", time.perf_counter()))
    pmf = nusc_model("PMFNet", dev)
    counts = {"launches_nusc": [nuscenes_inference(dev, pmf, "PMFNet", raw, smi, "[nusc] (c)"),
                                nuscenes_batched_eval(dev, pmf, raw, smi)]}
    nuscenes_r50_item(dev, raw, smi)
    marks.append(("(c)", time.perf_counter()))
    counts["launches_nusc_train"] = [train_path(
        dev, smi, "[nusc] (d)", "PMF-ResNet34 nuScenes",
        nusc_opts("PMFNet", n_epochs=5, warmup_epochs=1), frame, (NTH, NTW), (NH, NW),
        ("rasterize_zbuffer", "zbuffer_keys"), BN_TRAIN_STEP["PMFNet"], model=pmf)]
    del pmf
    marks.append(("(d)", time.perf_counter()))
    epmf = nusc_model("EPMFNet", dev)
    counts["launches_nusc_epmf"] = [nuscenes_inference(dev, epmf, "EPMFNet", frame, smi,
                                                       "[nusc] (e)")]
    counts["launches_nusc_epmf_train"] = [epmf_nuscenes_train_step(dev, epmf, raw, smi)]
    del epmf
    counts["launches_nusc_salsanext"] = [salsanext_nuscenes_scan(dev, raw, smi)]
    marks.append(("(e)", time.perf_counter()))
    print("[time] phase 9: " + ", ".join(f"{name} {t - t0:.1f} s" for (_, t0), (name, t)
                                          in zip(marks, marks[1:])))
    for name in out:
        for key, runs in counts.items():
            out[name][key] = sum(r[name] for r in runs)
    return out


def a2d2_opts(**kw):
    """Options of configs/experiments/epmf_a2d2.yaml as shipped, the groups
    the port reads written out (this script reads no YAML): EPMFNet, 39
    classes, base 32, bf16, multi-task loss, image-domain Lovász."""
    from pmf_tpu_torch.config import Options

    pv = {"canvas_h": AH, "canvas_w": AW, "proj_h": AEH, "proj_w": AEW, "proj_ht": ATH,
          "proj_wt": ATW, "n_points": AN, "img_jitter": [0.4, 0.4, 0.4],
          "pcd_mean": [17.95, 16.17, -0.17, 1.23, 18.49],
          "pcd_stds": [24.00, 23.55, 8.06, 3.96, 21.45]}
    config = {"PVconfig": pv, "augmentation": {"img_jitter": [0.4, 0.4, 0.4]},
              "use_mtloss": True, "point_lovasz": False}
    return Options(config=config, dataset="a2d2", net_type="EPMFNet", nclasses=39,
                   base_channels=32, compute_dtype="bfloat16", batch_size=(ABT, ABV), **kw)


def sensat_opts(**kw):
    """Options of configs/experiments/pmf_sensat.yaml as shipped: PMFNet, 14
    classes, base 32, float32, 320 x 320 crops and tiles, batch 4."""
    from pmf_tpu_torch.config import Options

    sensor = {"proj_h": SS, "proj_w": SS, "proj_ht": SS, "proj_wt": SS, "n_samples_split": 200}
    knn = {"KNN": {"params": {"knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}}
    return Options(config={"sensor": sensor, "augmentation": {}, "post": knn},
                   dataset="SensatUrban", net_type="PMFNet", nclasses=14, base_channels=32,
                   batch_size=(SBT, SBT), **kw)


def a2d2_scans(raw):
    """reader(i) → scan i of `raw` (the arrays of `make_a2d2_inputs`) as
    `infer_a2d2.a2d2_scan_reader` gives it: its valid points, labels and
    pixels, and its image."""
    def read(i):
        v = raw[2][i]
        return {"points": raw[0][i][v], "labels": raw[1][i][v], "rows": raw[3][i][v],
                "cols": raw[4][i][v], "image": raw[5][i]}

    return read


def reset_launches():
    from pmf_tpu_torch.ops import aspp, epilogue, epilogue_train, rasterize, zbuffer

    zbuffer.zbuffer_keys.launches = 0
    rasterize.rasterize_zbuffer.launches = 0
    aspp.aspp_branches.launches = 0
    epilogue.conv_epilogue.launches = 0
    epilogue_train.bn_epilogue.launches = 0


def graph_counts(model) -> tuple[int, int]:
    """The CUDA graphs' captures and replays of `model`'s class
    (models/graphs.py)."""
    return type(model).graph_captures, type(model).graph_replays


def read_launches() -> dict:
    from pmf_tpu_torch.ops import aspp, epilogue, rasterize, zbuffer

    torch.cuda.synchronize()
    return {"zbuffer_keys": zbuffer.zbuffer_keys.launches,
            "rasterize_zbuffer": rasterize.rasterize_zbuffer.launches,
            "aspp_branches": aspp.aspp_branches.launches,
            "conv_epilogue": epilogue.conv_epilogue.launches}



def check_a2d2_kernels(dev, raw, smi):
    """10(a): K2 at the A2D2 train view's own inputs (6 scans of 32768
    points into 320x960, the trainer's draws: 32-bit keys) and at the
    validation view's (10 scans into 480x1280), and K1 on one scan at
    A2D2Inference's own window (32768 points into 480x1280: 15 index bits),
    each with forced ties, held to its plain version exactly and timed as in
    phase 3 (`a2d2_` keys; `a2d2_val_` for K2's validation batch)."""
    from pmf_tpu_torch.data import v2_config
    from pmf_tpu_torch.data.perspective_pipeline_v2 import v2_view_geometry
    from pmf_tpu_torch.ops.scatter import packed_keys
    from pmf_tpu_torch.tools.infer_a2d2 import A2D2Inference

    opts = a2d2_opts()
    cfg = v2_config(opts)
    out = {"rasterize_zbuffer": {}, "zbuffer_keys": {}}
    for prefix, b, train, (h, w), seed in (("a2d2_", ABT, True, (ATH, ATW), 6),
                                           ("a2d2_val_", ABV, False, (AEH, AEW), 7)):
        batch = on([a[:b] for a in raw], dev)
        rows, cols, keep, depth, vals, _ = v2_view_geometry(
            *batch[:3], None, *batch[5:], cfg, train,
            torch.Generator(device=dev).manual_seed(opts.seed), pix=(batch[3], batch[4]))
        rows, cols, depth, keep = force_ties(rows, cols, depth, keep, seed=seed, h=h)
        vals = vals.contiguous()
        err = hold_rasterize(f"A2D2 {'train' if train else 'validation'} view, 32-bit keys, "
                             "forced ties", rows, cols, depth, keep, vals, h, w)
        numbers = {"max_abs_err": err, **rasterize_numbers(rows, cols, depth, keep, vals, h, w)}
        out["rasterize_zbuffer"].update({prefix + k: v for k, v in numbers.items()})
        print_numbers("rasterize_zbuffer", out["rasterize_zbuffer"], smi, prefix)

    inference = A2D2Inference(opts, None, a2d2_scans(raw), 1, dev)
    rows, cols, keep, depth, _, _ = inference.window(a2d2_scans(raw)(0))
    rows, cols, depth, keep = force_ties(rows[None], cols[None], depth[None], keep[None], seed=8,
                                         h=AEH)
    pix, key, nbits = packed_keys(rows, cols, depth, keep, AEH, AEW, 1 / 64)
    p1, k1 = pix.contiguous(), key.contiguous()
    err = hold_keys(f"A2D2Inference window, {nbits} index bits, forced ties", p1, k1, AEH, AEW)
    numbers = {"max_abs_err": err, **keys_numbers(p1, k1, AEH, AEW, int(keep.sum()))[0]}
    out["zbuffer_keys"] = {"a2d2_" + k: v for k, v in numbers.items()}
    print_numbers("zbuffer_keys", out["zbuffer_keys"], smi, "a2d2_")
    out["zbuffer_keys"].update({"a2d2_val_" + k: None for k in numbers})  # K2's batch only
    return out


def quarter_turns(aug):
    """SensatAugParams with each rotation replaced by a quarter turn (-1 to
    2 of them): the crop's cells then map near integer source coordinates,
    which a last-place difference between two devices' cos and sin cannot
    move across a rounding edge."""
    turns = torch.arange(aug.theta.numel()).reshape(aug.theta.shape) % 4 - 1
    return aug._replace(theta=turns.float() * (np.pi / 2))


def sensat_view(d, fm, lm, cfg, train, aug=None):
    """build_sensat_batch on device `d` as (feature, occupancy, label)."""
    from pmf_tpu_torch.data import build_sensat_batch

    if aug is not None:
        aug = type(aug)(*(t.to(d) for t in aug))
    f, lab = build_sensat_batch(*on((fm, lm), d), cfg, train, aug_override=aug)
    return f, f[..., 4] > 0, lab


def check_a2d2_sensat_reference(dev):
    """10(b): a small EPMFNet (39 classes, base 8) on the pixel-index V2 view
    and a small PMFNet (14 classes, base 8) on build_sensat_batch (eval, and
    train with fixed draws whose rotations are quarter turns), in float32 on
    the card against the CPU as phase 4 holds them; then one float32 EPMF
    A2D2 train step (multi-task loss, a fixed augmentation) and one float32
    SensatUrban train step (Dice, AMSGrad) on 32x32 crops, as 6(b), each
    with its BN statistics held in the float64 step, as 7(b): the deepest
    BN sees 8 pixels a batch (EPMF at 1/32 of 64x128; ResNet34's layer4 at
    1x1 for each of 2 crops of 32x32), and its float32 variance
    E[x²] − E[x]² moves in the fifth digit with the order of the sums."""
    from pmf_tpu_torch.data import SensatConfig, V2AugParams, V2Config, build_v2_batch_pix
    from pmf_tpu_torch.data.sensat_urban import draw_sensat_aug
    from pmf_tpu_torch.data.synthetic import make_a2d2_inputs, make_sensat_frame
    from pmf_tpu_torch.losses import init_multi_task_params
    from pmf_tpu_torch.models import EPMFNet, PMFNet, random_weights

    raw = make_a2d2_inputs(np.random.default_rng(31), 2, 4096, 3000, 96, 192)
    cfg = V2Config(canvas_h=96, canvas_w=192, proj_h=64, proj_w=128, proj_ht=64, proj_wt=128,
                   n_points=4096)
    torch.manual_seed(31)
    model = random_weights(EPMFNet(nclasses=39, base_channels=8), seed=31)
    hold_card_to_cpu(dev, "[a2d2] (b) EPMF pixel-index view",
                     lambda d: build_v2_batch_pix(*on(raw, d), cfg), model)
    full = lambda v, dt: torch.full((2,), v, dtype=dt)
    aug = V2AugParams(full(1.1, torch.float32), full(True, torch.bool),
                      full(np.deg2rad(7.0), torch.float32), full(4, torch.int64),
                      full(20, torch.int64), fixed_aug(2, "cpu").jitter)
    f, _, lab = build_v2_batch_pix(*map(torch.from_numpy, raw), cfg, train=True,
                                   aug_override=aug)
    model = random_weights(EPMFNet(nclasses=39, base_channels=8, dropout_rate=0.0), seed=32)
    sigma = init_multi_task_params(6) * torch.linspace(0.5, 2.0, 6)
    hold_train_step(dev, "[a2d2] (b) f32 EPMF A2D2 train step (multi-task loss) card vs CPU at "
                    "2x64x128, base 8", model, (f, lab, None), sigma, stats_in_float64=True,
                    nclasses=39)

    frame, _ = make_sensat_frame(np.random.default_rng(33), 40000, 12.0)
    fm = np.stack([frame["feature_map"][:, :64, :64], frame["feature_map"][:, -64:, -64:]])
    lm = np.stack([frame["label_map"][:64, :64], frame["label_map"][-64:, -64:]])
    crop = SensatConfig(img_h=32, img_w=32)
    aug = quarter_turns(draw_sensat_aug(torch.Generator().manual_seed(33), 2, 64, 64, crop))
    model = random_weights(PMFNet(nclasses=14, base_channels=8), seed=2)
    hold_card_to_cpu(dev, "[sensat] (b) PMF BEV eval view",
                     lambda d: sensat_view(d, fm, lm, SensatConfig(img_h=64, img_w=64), False),
                     model)
    hold_card_to_cpu(dev, "[sensat] (b) PMF BEV train crop (quarter turns, flips, jitter)",
                     lambda d: sensat_view(d, fm, lm, crop, True, aug), model)
    f, _, lab = sensat_view("cpu", fm, lm, crop, True, aug)
    model = random_weights(PMFNet(nclasses=14, base_channels=8, dropout_rate=0.0), seed=34)
    hold_train_step(dev, "[sensat] (b) f32 SensatUrban train step (Dice, AMSGrad) card vs CPU "
                    "at 2x32x32, base 8", model, (f, lab, None), stats_in_float64=True,
                    nclasses=14, sensat=True)


def a2d2_batched_eval(dev, model, raw, smi):
    """10(c), second part: the batched A2D2 validation view
    (build_v2_batch_pix → K2 → `model`, EPMFNet → argmax) at batch 10,
    480x1280, against the same with the plain fill; scans/s. Returns the
    launch counts."""
    from pmf_tpu_torch.data import build_v2_batch_pix, v2_config
    from pmf_tpu_torch.data.perspective_pipeline_v2 import _build_v2_batch
    from pmf_tpu_torch.ops import argmax_last, rasterize

    cfg = v2_config(a2d2_opts())
    batch = on([a[:ABV] for a in raw], dev)

    def batched():
        f, m, lab = build_v2_batch_pix(*batch, cfg)
        lidar, _ = model(f[..., :5], f[..., 5:8])
        return f, m, lab, lidar, argmax_last(lidar)

    reset_launches()
    with torch.inference_mode():
        f, m, lab, lidar, pred = batched()
        launches = read_launches()
        if launches["rasterize_zbuffer"] == 0 or launches["aspp_branches"] != 2 \
                or launches["conv_epilogue"] != EPILOGUES["EPMFNet"]:
            fail(f"[a2d2] (c) K2 was not launched on the batched view, or the ASPP kernel "
                 f"not twice (EPMF's two ASPPs), or the conv epilogue not once a conv: "
                 f"{launches}")
        if lidar.shape != (ABV, AEH, AEW, 39) or not torch.isfinite(lidar).all() \
                or pred.unique().numel() < 2:
            fail(f"[a2d2] (c) batched probabilities {tuple(lidar.shape)}, finite "
                 f"{bool(torch.isfinite(lidar).all())}, {pred.unique().numel()} classes")
        plain = _build_v2_batch(*batch[:3], None, *batch[5:], cfg,
                                fill=rasterize.rasterize_zbuffer_plain, pix=(batch[3], batch[4]))
        if not all(torch.equal(x, y) for x, y in zip((f, m, lab), plain)):
            fail("[a2d2] (c) the batched view gives other features, mask or labels with the "
                 "plain fill")
        for _ in range(2):
            batched()
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        profile_step(batched, smi, name="eval batch (A2D2 build_v2_batch_pix+EPMFNet+argmax)")
    med = statistics.median(times)
    print(f"[a2d2] (c) batched eval build_v2_batch_pix+EPMFNet+argmax, batch {ABV}, {AEH}x{AEW}, "
          f"{AN} points, bf16: kernel fill == plain fill; {int(m.sum())} occupied pixels; "
          f"{ABV / med:.2f} scans/s (median of {len(times)} batches: {med * 1e3:.2f} ms, min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) on {smi}")
    return launches


def a2d2_paths(dev, raw, smi):
    """10(c): EPMF-ResNet34 at epmf_a2d2.yaml's full width (bf16, random
    weights from a seed): A2D2Inference.run over 4 scans (K1 once a scan),
    the batched validation view at batch 10, then the A2D2 Trainer at batch
    6, 320x960 (multi-task loss, image-domain Lovász: K2 only). Returns the
    eval paths' and the Trainer's launch counts."""
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.tools.infer_a2d2 import A2D2Inference

    opts = a2d2_opts(n_epochs=5, warmup_epochs=1)
    torch.manual_seed(0)
    model = random_weights(build_model(opts), seed=0).to(dev)
    scans = a2d2_scans(raw)
    A2D2Inference(opts, model, scans, 1, dev).run()                 # warm-up scan
    captures, replays = graph_counts(model)
    reset_launches()
    report = A2D2Inference(opts, model, scans, 4, dev).run()
    launches = read_launches()
    # the first scan warms up and captures the net's CUDA graphs
    # (models/graphs.py), each scan replays them
    if launches != {"zbuffer_keys": 4, "rasterize_zbuffer": 0, "aspp_branches": 4,
                    "conv_epilogue": 2 * EPILOGUES["EPMFNet"]} or \
            graph_counts(model) != (captures + 1, replays + 4) or \
            not all(np.isfinite(v) for v in report.values()):
        fail(f"[a2d2] (c) A2D2Inference over 4 scans: {report}, launches {launches}, the "
             f"net's graphs captured and replayed "
             f"{tuple(a - b for a, b in zip(graph_counts(model), (captures, replays)))} times")
    print(f"[a2d2] (c) A2D2Inference.run (EPMF, bf16, {AEH}x{AEW} window, {AN} points): "
          f"{report['ms_per_scan']:.2f} ms/scan over 4 scans (window, forward, labels; after one "
          f"warm-up scan); point mIoU {report['mIoU']:.4f}; launches {json.dumps(launches)} on "
          f"{smi}")
    with torch.inference_mode():
        inference = A2D2Inference(opts, model, scans, 1, dev)
        profile_step(lambda: inference.scan(scans(0)), smi, name="one scan of A2D2Inference.run")
    batched = a2d2_batched_eval(dev, model, raw, smi)
    eval_launches = {k: launches[k] + batched[k] for k in launches}
    train = train_path(dev, smi, "[a2d2] (c)", "EPMF-ResNet34 A2D2", opts, raw, (ATH, ATW),
                       (AEH, AEW), ("rasterize_zbuffer",), BN_TRAIN_STEP["EPMFNet"],
                       model=model, keys=PIX_KEYS)
    if train["zbuffer_keys"] != 0:
        fail(f"[a2d2] (c) K1 was launched on the A2D2 train path (no point Lovász): {train}")
    return eval_launches, train


def write_sensat_frame(frame: dict, fields: dict, root) -> None:
    """The tile as prepare_bev_frames and the label dump leave it: val/tile
    .npz, .ply and .bin under `root`, and train/ the same files."""
    import os

    from pmf_tpu_torch.data.sensat_urban import write_ply

    val = os.path.join(root, "val")
    os.makedirs(val, exist_ok=True)
    np.savez(os.path.join(val, "tile.npz"), **frame)
    write_ply(os.path.join(val, "tile.ply"), fields)
    fields["class"].tofile(os.path.join(val, "tile.bin"))
    if not os.path.exists(os.path.join(root, "train")):
        os.symlink("val", os.path.join(root, "train"))


def sensat_paths(dev, smi):
    """10(d): PMF-ResNet34 at pmf_sensat.yaml's width (base 32, float32,
    TF32 off, random weights from a seed) on a synthetic tile of about 2e6
    points over 120 x 120 m (SF x SF cells, written under build/):
    SensatInference.run at scales 320, 448 and 576 with the 7 test-time
    views (34 windows, 238 window views), then with the KNN lift; then the
    SensatUrban Trainer at batch 4, 320x320 (Dice, AMSGrad) on windows cut by
    the train reader. Returns the launch counts of its eval and train paths
    (no kernel is on them)."""
    import os

    from pmf_tpu_torch.data import SensatUrban, build_sensat_batch, sensat_config
    from pmf_tpu_torch.data.loader import sensat_sample_reader
    from pmf_tpu_torch.data.synthetic import make_sensat_frame
    from pmf_tpu_torch.models import PMFNet, random_weights
    from pmf_tpu_torch.tools.infer_sensat import SensatInference

    t0 = time.perf_counter()
    frame, fields = make_sensat_frame(np.random.default_rng(35), int(2e6 * (SF / 1200) ** 2),
                                      SF / 10)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sensat_smoke")
    write_sensat_frame(frame, fields, root)
    print(f"[sensat] (d) synthetic tile: {len(fields['x'])} points, "
          f"{'x'.join(map(str, frame['label_map'].shape))} cells, "
          f"{(frame['label_map'] >= 0).mean():.4f} occupied; made and written in "
          f"{time.perf_counter() - t0:.1f} s")
    opts = sensat_opts(n_epochs=5, warmup_epochs=1)
    torch.manual_seed(0)
    model = random_weights(PMFNet(nclasses=14, base_channels=32), seed=2).to(dev)
    dataset = SensatUrban(root, "val", keep_idx=True)
    make = lambda knn: SensatInference(opts, model, dataset, dev, SCALES, use_knn=knn)
    with torch.inference_mode():                                  # one window of each size
        for size in SCALES:
            make(False).predict_window(torch.zeros((size, size, 8), device=dev))
    reset_launches()
    reports = [make(False).run(), make(True).run()]
    eval_launches = read_launches()
    for tag, r in zip(("TTA", "TTA + KNN"), reports):
        if not all(np.isfinite(v) for v in r.values()) or "point_mIoU" not in r:
            fail(f"[sensat] (d) SensatInference ({tag}): {r}")
        print(f"[sensat] (d) SensatInference.run ({tag}, scales {SCALES}, float32): "
              f"{r['ms_per_frame']:.2f} ms/frame, {r['ms_per_forward']:.3f} ms per window view "
              f"(7 a forward); 2D mIoU {r['mIoU']:.4f}, point mIoU "
              f"{r['point_mIoU']:.4f} on {smi}")
    knn_ms = reports[1]["ms_per_frame"] - reports[0]["ms_per_frame"]
    print(f"[sensat] (d) the KNN lift adds {knn_ms:.2f} ms/frame; launches "
          f"{json.dumps(eval_launches)} (no kernel on this path)")
    window = torch.as_tensor(frame["feature_map"][:, :SCALES[-1], :SCALES[-1]],
                             device=dev).permute(1, 2, 0)
    with torch.inference_mode():
        profile_step(lambda: make(False).predict_window(window), smi,
                     name=f"one {SCALES[-1]}x{SCALES[-1]} window, 7 test-time views, of "
                     "SensatInference.run")

    read = sensat_sample_reader(SensatUrban(root, "train"), sensat_config(opts, True), [0],
                                rng=np.random.RandomState(opts.seed))
    windows = [read(i) for i in range(2 * SBT)]
    raw = [np.stack([w[k] for w in windows]) for k in ("feature_map", "label_map")]
    train = train_path(dev, smi, "[sensat] (d)", "PMF-ResNet34 SensatUrban", opts, raw,
                       (SS, SS), (2 * SS, 2 * SS), (), 0, model=model,
                       keys=("feature_map", "label_map"))
    _, _, attempts = build_sensat_batch(*on([a[:SBT] for a in raw], dev),
                                        sensat_config(opts, True), True,
                                        torch.Generator(device=dev).manual_seed(1),
                                        return_attempts=True)
    print(f"[sensat] (d) the train crop's redraws: {attempts.tolist()} attempts for the "
          f"{SBT} samples of a batch (at most 11, min_valid 0.1)")
    return eval_launches, train


def a2d2_sensat_phase(dev, smi):
    """Phase 10: A2D2 and SensatUrban. Returns the kernels' A2D2 numbers
    and launch counts, by kernel name; prints the time of each part."""
    from pmf_tpu_torch.data.synthetic import make_a2d2_inputs

    marks = [("", time.perf_counter())]
    raw = make_a2d2_inputs(np.random.default_rng(30), 2 * ABT, AN, AN * 27000 // 32768, AH, AW)
    marks.append(("data", time.perf_counter()))
    out = check_a2d2_kernels(dev, raw, smi)
    marks.append(("(a)", time.perf_counter()))
    check_a2d2_sensat_reference(dev)
    marks.append(("(b)", time.perf_counter()))
    launches_eval, launches_train = a2d2_paths(dev, raw, smi)
    del raw
    marks.append(("(c)", time.perf_counter()))
    sensat_eval, sensat_train = sensat_paths(dev, smi)
    marks.append(("(d)", time.perf_counter()))
    print(f"[sensat] (d) launches: eval {json.dumps(sensat_eval)}, train "
          f"{json.dumps(sensat_train)}")
    print("[time] phase 10: " + ", ".join(f"{name} {t - t0:.1f} s" for (_, t0), (name, t)
                                           in zip(marks, marks[1:])))
    for name in out:
        out[name]["launches_a2d2"] = launches_eval[name]
        out[name]["launches_a2d2_train"] = launches_train[name]
    return out


def read_epoch(log_path: str, mode: str, epoch: int) -> dict:
    """The numbers of the Trainer's '{mode} epoch {epoch}: key value ...'
    line in a run's experiment.log."""
    with open(log_path) as f:
        lines = [ln for ln in f if f"{mode} epoch {epoch}: " in ln]
    if not lines:
        fail(f"[cli] no '{mode} epoch {epoch}' line in {log_path}")
    words = lines[-1].split(f"{mode} epoch {epoch}: ", 1)[1].split()
    return {k: float(v) for k, v in zip(words[::2], words[1::2])}


def cli_train(dev, smi, ref_ms: float) -> dict:
    """11(a): tools/train.py's main on files, at pmf_kitti.yaml's shapes
    with bench.py's batch: a SemanticKITTI tree (data/synthetic.py:
    write_kitti_tree; KT scans in sequence 00, KV in 08) and a
    torchvision-named ResNet34 state_dict from a seed as
    `pretrained_weights`, 2 epochs, --overwrite-policy delete. Checks that
    the encoder took the state_dict's tensors, the run directory's layout,
    finite losses and both kernels launched; returns their counts."""
    import yaml

    from pmf_tpu_torch.config import load_options
    from pmf_tpu_torch.data import native
    from pmf_tpu_torch.data.synthetic import resnet_state_dict, write_kitti_tree
    from pmf_tpu_torch.tools import train as train_cli

    root = os.path.abspath(os.path.join("build", "cli_smoke"))
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data = write_kitti_tree(root, {0: KT, 8: KV}, N, KH, KW, seed=12)
    sd = resnet_state_dict(seed=13)
    weights = os.path.join(root, "resnet34.pth")
    torch.save(sd, weights)
    t_write = time.perf_counter() - t0
    with open(os.path.join("configs", "experiments", "pmf_kitti.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["sensor"].update(canvas_h=H, canvas_w=W + 16, proj_h=H, proj_w=W, proj_ht=TH,
                         proj_wt=TW, n_points=N)
    cfg.update(save_path=os.path.join(root, "runs"), data_root=data, batch_size=[B, B],
               n_epochs=2, pretrained_weights=weights)
    path = os.path.join(root, "pmf_kitti.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    run_dir = load_options(path).run_dir
    os.makedirs(os.path.join(run_dir, "stale"))         # what --overwrite-policy delete removes

    loaded = {}
    load = train_cli.load_pretrained_resnet

    def load_and_keep(model, *args, **kw):
        out = load(model, *args, **kw)
        loaded.update({k: v.clone() for k, v in model.camera_stream_encoder.state_dict().items()})
        return out

    train_cli.load_pretrained_resnet = load_and_keep
    reset_launches()
    try:
        t0 = time.perf_counter()
        best = train_cli.main([path, "--overwrite-policy", "delete", "--device", dev.type])
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
    finally:
        train_cli.load_pretrained_resnet = load
    launches = read_launches()

    wrong = [k for k, v in sd.items() if not k.startswith("fc.") and
             not k.endswith("num_batches_tracked") and not torch.equal(loaded.get(k), v)]
    if not loaded or wrong:
        fail(f"[cli] (a) the encoder did not take the pretrained tensors: {wrong[:5]}")
    want = ["settings.json", "log/experiment.log", "log/scalars.jsonl", "log/images",
            "code/pmf_tpu_torch/tools/train.py", "checkpoint/checkpoint.pth",
            *(f"checkpoint/best_{k}_model.pth" for k in ("Acc", "IOU", "Recall", "last"))]
    missing = [w for w in want if not os.path.exists(os.path.join(run_dir, w))]
    if missing or os.path.exists(os.path.join(run_dir, "stale")):
        fail(f"[cli] (a) run directory {run_dir}: missing {missing}, or the stale entry kept")
    with open(os.path.join(run_dir, "log", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    tags = {r["tag"] for r in scalars}
    losses = [r["value"] for r in scalars if "Loss" in r["tag"]]
    needed = {f"{m}_{t}" for m in ("Train", "Validation")
              for t in ("Loss", "meanIOU", "LossLovasz", "LossImageFocal", "Image_meanIOU")}
    images = os.listdir(os.path.join(run_dir, "log", "images"))
    if not needed <= tags or not losses or not np.all(np.isfinite(losses)) or not images:
        fail(f"[cli] (a) scalars: missing {sorted(needed - tags)}, losses {losses[:8]}, "
             f"{len(images)} image panels")
    if launches["rasterize_zbuffer"] == 0 or launches["zbuffer_keys"] == 0:
        fail(f"[cli] (a) a kernel of the train path was not launched: {launches}")
    ep = read_epoch(os.path.join(run_dir, "log", "experiment.log"), "Train", 1)
    ms = (ep["DataTime"] + ep["StepTime"]) / ep["Steps"] * 1e3
    share = ep["DataTime"] / (ep["DataTime"] + ep["StepTime"])
    reader = "native (native/libpmfloader.so)" if native.available() else \
        f"numpy + PIL (the native library does not load: {native.load_error()})"
    print(f"[cli] (a) tools/train.py main on files: PMF-ResNet34 {cfg['compute_dtype']}, batch "
          f"{B}, {TH}x{TW} crop, point Lovász, n_threads {cfg['n_threads']}, {KT} train + {KV} "
          f"validation scans of {N} points with {KW}x{KH} PNGs, pretrained ResNet34 "
          f"({len(loaded)} encoder tensors equal to the state_dict's); reader: {reader}")
    print(f"[cli] (a) epoch 1: {ms:.2f} ms/step over {ep['Steps']:.0f} steps, data-time share "
          f"{share:.4f} (DT {ep['DataTime']:.3f} s of {ep['DataTime'] + ep['StepTime']:.3f} s); "
          f"the in-memory Trainer of 6(c): {ref_ms:.2f} ms/step, a gap of "
          f"{ms - ref_ms:+.2f} ms/step (host-inclusive) on {smi}")
    print(f"[cli] (a) tree written in {t_write:.1f} s, main() {t_main:.1f} s (2 epochs, 2 "
          f"validations, image panels at epoch 0); best {best}; {len(tags)} scalar tags, "
          f"{len(images)} image panels; launches {json.dumps(launches)}")
    return launches


def time_trainer(dev, opts, raw, model, steps: int = 6) -> float:
    """ms/step of the in-memory Trainer (2 steps an epoch) over `steps`
    steps after 2 warm-up steps."""
    from pmf_tpu_torch.train import Trainer

    trainer = Trainer(opts, model, scan_reader(raw, 2 * B), 2 * B, scan_reader(raw, 2 * B), B,
                      dev, [0.0] + [1.0] * 19)
    trainer.run(0, "Train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(1, 1 + steps // 2):
        run = trainer.run(epoch, "Train")
    torch.cuda.synchronize()
    if not np.isfinite(run["Loss"]):
        fail(f"[nccl] (b) non-finite loss {run}")
    return (time.perf_counter() - t0) / steps * 1e3


def nccl_world1(dev, smi) -> dict:
    """11(b): a process group of one on NCCL through init_distributed
    (torchrun's variables with a local MASTER_ADDR and a free port). The
    small step of parallel/dryrun.py, 2 steps, with the group up equals the
    same steps without it, each parameter to 1 float32 ulp: every
    collective runs and is an identity. The step runs in float64 and its
    parameters are compared as float32: the card's float32 step is not
    repeatable bit for bit (the backward of the bilinear upsampling adds
    with atomics in any order; two float32 runs without the group are
    printed), while float64's reordering stays far under a float32 ulp.
    Then the full-width Trainer (6(c)'s) without and with the group:
    ms/step, and the kernels' launches with the group up (returned)."""
    import torch.distributed as dist

    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data.synthetic import make_inputs
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.parallel import dryrun, init_distributed, shutdown

    small = lambda dtype: dryrun.train_step(slice(0, dryrun.ROWS), dryrun.ROWS, seed=3,
                                            dtype=dtype, device=dev, steps=2)["params"]
    ulps = lambda a, b: max(float((np.abs(a[k].astype(np.float32) - b[k].astype(np.float32)) /
                                   np.spacing(np.abs(b[k].astype(np.float32)))).max())
                            for k in b)
    rel = lambda a, b: max(float(np.linalg.norm(a[k] - b[k]) / max(np.linalg.norm(b[k]), 1e-30))
                           for k in b)
    sensor = {"canvas_h": H, "canvas_w": W + 16, "proj_h": H, "proj_w": W, "proj_ht": TH,
              "proj_wt": TW, "h_pad": 7, "w_pad": 3, "n_points": N}
    opts = Options(config={"sensor": sensor, "augmentation": {"img_jitter": [0.4, 0.4, 0.4]}},
                   compute_dtype="bfloat16", batch_size=(B, B), n_epochs=5, warmup_epochs=1)
    raw = make_inputs(np.random.default_rng(14), 2 * B, N, H, W)
    torch.manual_seed(0)
    model = random_weights(build_model(opts), seed=0).to(dev)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(dryrun.free_port())}
    try:
        alone, again = small(torch.float64), small(torch.float64)
        alone32, again32 = small(torch.float32), small(torch.float32)
        ms_alone = time_trainer(dev, opts, raw, model)
        os.environ.update(env)
        rank_size = init_distributed(dev)
        backend = dist.get_backend()
        grouped, grouped32 = small(torch.float64), small(torch.float32)
        reset_launches()
        ms_group = time_trainer(dev, opts, raw, model)
        launches = read_launches()
        bn_group = bn_train_launches()
    finally:
        shutdown()
        for k in env:
            os.environ.pop(k, None)
        torch.backends.cudnn.deterministic = deterministic
    noise, err = ulps(again, alone), ulps(grouped, alone)
    noise32, err32 = rel(again32, alone32), rel(grouped32, alone32)
    if rank_size != (0, 1) or backend != ("nccl" if dev.type == "cuda" else "gloo") or err > 1:
        fail(f"[nccl] (b) group {rank_size} on {backend}: parameters after 2 steps differ from "
             f"the run without the group by {err:.3g} float32 ulp (tolerance 1; run to run "
             f"{noise:.3g})")
    if launches["rasterize_zbuffer"] == 0 or launches["zbuffer_keys"] == 0:
        fail(f"[nccl] (b) a kernel of the train path was not launched: {launches}")
    if bn_group:
        fail(f"[nccl] (b) the train-mode epilogue ran {bn_group} times with the group up")
    print(f"[nccl] (b) init_distributed: rank 0 of 1 on {backend}; the small step "
          f"(dryrun.train_step, {dryrun.ROWS}x{dryrun.TH}x{dryrun.TW}, 2 steps) in float64 with "
          f"the group: parameters as float32 within {err:.3g} ulp of the run without it (tol "
          f"1; two runs without: {noise:.3g} ulp); in float32: {err32:.3g} of a parameter's "
          f"norm from the run without it, two runs without {noise32:.3g}")
    print(f"[nccl] (b) the full-width Trainer (PMF-ResNet34 bf16, batch {B}, {TH}x{TW}): "
          f"{ms_alone:.2f} ms/step without the group, {ms_group:.2f} ms/step with it "
          f"({ms_group - ms_alone:+.2f} ms: the collectives at world 1; 6 steps after 2 "
          f"warm-up each, host-inclusive) on {smi}; launches {json.dumps(launches)}")
    return launches



SPLIT_MODEL = 2     # phase 12: the ranks a sample's rows are split over


def split_view(dev, raw, train: bool):
    """Phase 12's PMF nuScenes batch of `raw` through K2: the eval view
    (NBV items, NH x NW) or the train view (NBT items, NTH x NTW, fixed
    draws) with the points' winner flags (K1): (feature, label, points)."""
    from pmf_tpu_torch.data import build_batch, pv_config

    cfg = pv_config(nusc_opts("PMFNet"))
    with torch.no_grad():
        if not train:
            f, _, lab = build_batch(*on([a[:NBV] for a in raw], dev), cfg)
            return f, lab, None
        aug = fixed_aug(NBT, dev, top=(NCH - NTH) // 3, left=(NCW - NTW) // 3)
        f, _, lab, pts = build_batch(*on([a[:NBT] for a in raw], dev), cfg, True,
                                     aug_override=aug, return_points=True)
    return f, lab, pts


def split_eval(model, f, mesh=None, argmax=False, gather=True):
    """The eval forward of `model` on the batch `f`, under `mesh`'s row split
    when given (the outputs gathered whole unless not `gather`); with
    `argmax` the argmax of each output instead of the probabilities."""
    import contextlib

    from pmf_tpu_torch.ops import argmax_last
    from pmf_tpu_torch.parallel import spatial

    with mesh.split() if mesh else contextlib.nullcontext(), torch.no_grad():
        out = model(spatial.split_rows(f[..., :5]), spatial.split_rows(f[..., 5:8]))
        out = [argmax_last(o) if argmax else o for o in out]
        return [spatial.gather_rows(o) for o in out] if gather else out


def split_train(dev, f, lab, pts, mesh=None, dtype=torch.float32, remat=False,
                lovasz=True) -> dict:
    """One PMF nuScenes train step in `dtype` (nusc_model's weights, the
    hybrid optimizer, point Lovász, dropout from a seeded generator) on the
    batch, under `mesh`'s row split when given, with `remat` or without,
    with the Lovász terms or without them (λ = 0, no points): its loss
    terms and the averaged gradients and BN running variances after the
    update (on the host)."""
    import contextlib

    from pmf_tpu_torch.parallel import spatial
    from pmf_tpu_torch.train import HybridOptimizer, LossConfig, make_pmf_train_step

    model = nusc_model("PMFNet", dev).to(dtype)
    model.dtype = dtype
    opt = HybridOptimizer(model, lambda step: 1e-3, 0.9, 1e-5)
    cfg = LossConfig(nclasses=17, alpha=tuple([0.0] + [1.0] * 16),
                     lambda_=1.0 if lovasz else 0.0)
    step = make_pmf_train_step(model, opt, cfg, remat=remat)
    generator = torch.Generator(device=dev).manual_seed(5)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # two unsplit runs then differ by atomics alone
    try:
        with mesh.split() if mesh else contextlib.nullcontext():
            aux = step(spatial.split_rows(f.to(dtype)), spatial.split_rows(lab), generator,
                       pts if lovasz else None)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"losses": {k: float(v) for k, v in aux.items() if k not in ("conf", "conf_cam")},
            "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
            "var": {k: v.cpu() for k, v in model.state_dict().items() if "running_var" in k}}


def first_item(batch):
    """(feature, label, points) of a batch's first item."""
    f, lab, pts = batch
    return f[:1], lab[:1], tuple(p[:1] for p in pts)


def peak_gib() -> float:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def ms_per_call(fn, n: int = 3) -> float:
    """Host-inclusive ms of one call of `fn` over n calls after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def grad_distance(a: dict, b: dict) -> tuple[float, float]:
    """Gradients `a` from `b`: (‖Δg‖ / ‖g‖ over all parameters together,
    the largest ‖Δg‖ / (‖g‖ + 1e-4) parameter by parameter, which is under
    1e-3 when each ‖Δg‖ is within 1e-3 ‖g‖ + 1e-7, phase 6(b)'s tolerance:
    a conv bias before a train-mode BN has a gradient of zero but for
    rounding)."""
    num = sum(float((a[k].double() - v.double()).norm() ** 2) for k, v in b.items())
    den = sum(float(v.double().norm() ** 2) for v in b.values())
    each = max(float((a[k].double() - v.double()).norm() / (v.double().norm() + 1e-4))
               for k, v in b.items())
    return (num / den) ** 0.5, each


def split_job(rank: int, join, device: str = "cuda") -> dict:
    """Phase 12 in one of the two processes that share the card over gloo.
    Rank 0 first runs the references alone: the eval forward in float32 and
    bf16, two float32 train steps at the train batch and one float64 step on
    its first item unsplit, the small dryrun step in float64; then both join the group as data 1 x model 2 and run the same
    under the row split, the kernels' launches counted around (a) and (b).
    Peak memory is read over the forwards alone (the gathers for the
    comparison come after)."""
    from pmf_tpu_torch.data.synthetic import make_nuscenes_inputs
    from pmf_tpu_torch.parallel import dryrun
    from pmf_tpu_torch.utils import disable_tf32

    disable_tf32()
    dev = torch.device(device)
    raw = make_nuscenes_inputs(np.random.default_rng(21), 1, NN, 34720, NCH, NCW)
    out = {}
    if rank == 0:
        f, _, _ = split_view(dev, raw, train=False)
        model = nusc_model("PMFNet", dev)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            model.dtype = dtype
            torch.cuda.reset_peak_memory_stats()
            out[f"unsplit_ms_{tag}"] = ms_per_call(lambda: split_eval(model, f))
            out[f"unsplit_peak_{tag}"] = peak_gib()
            ref = split_eval(model, f, argmax=dtype != torch.float32)
            out[f"ref_{tag}"] = [o.cpu() for o in ref]
        del model, f, ref
        batch = split_view(dev, raw, train=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out["ref_train"] = split_train(dev, *batch)
        torch.cuda.synchronize()
        out["unsplit_ms_train"] = (time.perf_counter() - t0) * 1e3
        out["unsplit_peak_train"] = peak_gib()
        t0 = time.perf_counter()
        out["ref_train_again"] = split_train(dev, *batch)
        torch.cuda.synchronize()
        out["unsplit_ms_train_again"] = (time.perf_counter() - t0) * 1e3
        f, lab, pts = batch
        out["ref_train_nudged"] = split_train(dev, f * (1 + 2 ** -23), lab, pts)
        out["ref_train_nolovasz"] = split_train(dev, *batch, lovasz=False)
        out["ref_train_nolovasz_nudged"] = split_train(dev, f * (1 + 2 ** -23), lab, pts,
                                                       lovasz=False)
        del f
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out["ref_train_remat"] = split_train(dev, *batch, remat=True)
        torch.cuda.synchronize()
        out["unsplit_ms_train_remat"] = (time.perf_counter() - t0) * 1e3
        out["unsplit_peak_train_remat"] = peak_gib()
        out["ref_train64"] = split_train(dev, *first_item(batch), dtype=torch.float64)
        out["ref_dryrun"] = dryrun.train_step(slice(0, dryrun.ROWS), dryrun.ROWS, seed=3,
                                              device=dev)
        del batch
        torch.cuda.empty_cache()
    mesh = join()
    reset_launches()
    f, _, _ = split_view(dev, raw, train=False)
    model = nusc_model("PMFNet", dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        model.dtype = dtype
        torch.cuda.reset_peak_memory_stats()
        out[f"ms_{tag}"] = ms_per_call(lambda: split_eval(model, f, mesh, gather=False))
        out[f"peak_{tag}"] = peak_gib()
        got = split_eval(model, f, mesh, argmax=dtype != torch.float32)
        if rank == 0:
            ref = out.pop(f"ref_{tag}")
            if dtype == torch.float32:
                out["max_abs_err"] = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
            else:
                out["argmax_agree"] = min(float((g.cpu() == r).double().mean())
                                          for g, r in zip(got, ref))
        del got
    del model, f
    batch = split_view(dev, raw, train=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = split_train(dev, *batch, mesh=mesh)
    torch.cuda.synchronize()
    out["ms_train"] = (time.perf_counter() - t0) * 1e3
    out["peak_train"] = peak_gib()
    step64 = split_train(dev, *first_item(batch), mesh=mesh, dtype=torch.float64)
    out["launches"] = read_launches()
    step_remat = split_train(dev, *batch, mesh=mesh, remat=True)
    step_nolovasz = split_train(dev, *batch, mesh=mesh, lovasz=False)
    step64_remat = split_train(dev, *first_item(batch), mesh=mesh, dtype=torch.float64,
                               remat=True)
    del batch
    small = dryrun.train_step(slice(0, dryrun.ROWS), dryrun.ROWS, seed=3, device=dev, mesh=mesh)
    if rank == 0:
        ref, again = out.pop("ref_train"), out.pop("ref_train_again")
        out["loss_rel_err"] = max(abs(step["losses"][k] - v) / max(abs(v), 1e-30)
                                  for k, v in ref["losses"].items())
        out["losses"] = step["losses"]
        out["grad_err"], out["grad_err_each"] = grad_distance(step["grads"], ref["grads"])
        out["grad_noise"], out["grad_noise_each"] = grad_distance(again["grads"], ref["grads"])
        nudged = out.pop("ref_train_nudged")
        out["grad_nudge"], out["grad_nudge_each"] = grad_distance(nudged["grads"], ref["grads"])
        var_distance = lambda a: max(float((a[k] - v).norm() / v.norm()) for k, v in
                                     ref["var"].items())
        out["var_err"], out["var_nudge"] = var_distance(step["var"]), var_distance(nudged["var"])
        ref64 = out.pop("ref_train64")
        out["loss_rel_err64"] = max(abs(step64["losses"][k] - v) / max(abs(v), 1e-30)
                                    for k, v in ref64["losses"].items())
        out["grad_err64"], out["grad_err64_each"] = grad_distance(step64["grads"], ref64["grads"])
        out["dryrun"] = dryrun._compare(out.pop("ref_dryrun"), small)
        ref_remat = out.pop("ref_train_remat")
        out["grad_err_remat"] = grad_distance(step_remat["grads"], ref["grads"])
        out["grad_remat_unsplit"] = grad_distance(ref_remat["grads"], ref["grads"])
        nolov, nolov_nudged = out.pop("ref_train_nolovasz"), out.pop("ref_train_nolovasz_nudged")
        out["grad_err_nolovasz"] = grad_distance(step_nolovasz["grads"], nolov["grads"])
        out["grad_nudge_nolovasz"] = grad_distance(nolov_nudged["grads"], nolov["grads"])
        out["remat64"] = {
            "grads": grad_distance(step64_remat["grads"], step64["grads"]),
            "losses": max(abs(step64_remat["losses"][k] - v) / max(abs(v), 1e-30)
                          for k, v in step64["losses"].items()),
            "var": max(float((step64_remat["var"][k] - v).norm() / v.norm())
                       for k, v in step64["var"].items())}
    return out


def split_phase(dev, smi) -> dict:
    """Phase 12: the spatial split on the card. Two processes share it over
    gloo (one card cannot hold two NCCL ranks) as data 1 x model 2: (a)
    PMF-ResNet34 nuScenes eval at full width, the batched view at batch 4
    through K2, split against one process: float32 (TF32 off) probabilities
    within 1e-4, bf16 argmax equal on >= 99.5 % of the pixels; each rank's
    peak memory and ms/forward beside the unsplit run's; (b) the PMF
    nuScenes train step at its train view (batch 3, 640x960, K2's canvas
    with return_points, K1's winner flags for the point Lovász), split
    against one process: in float32 every loss term within 1e-4, peak
    memory, and the gradients' distance printed beside two unsplit runs'
    and beside the unsplit step's on features moved by an ulp (float32
    gradients of PMFNet move by percents with the order of the sums:
    check_train_reference); in float64, on the batch's first item (the
    float64 step of 3 items does not fit the card unsplit), every loss term
    within 1e-4 and each parameter's gradient within 1e-3 of its norm +
    1e-7 (`grad_distance`); (c) parallel/dryrun.py's small step in float64
    at model 2 equal to one process (losses 1e-5, BN statistics 1e-5,
    parameters 1e-5 of their norm, confusion exact). Returns the kernels'
    launches over (a) and (b), summed over the two ranks."""
    from pmf_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    try:
        ranks = dryrun.Grid(2, SPLIT_MODEL, split_job, (dev.type,), timeout_s=900.0).results()
    except (RuntimeError, TimeoutError) as e:
        fail(f"[split] {e}")
    r0 = ranks[0]
    launches = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    per_rank = lambda key: " / ".join(f"{r[key]:.2f}" for r in ranks)
    print(f"[split] (a) PMF-ResNet34 nuScenes eval, batch {NBV}, {NH}x{NW}, split over "
          f"{SPLIT_MODEL} ranks (gloo, one card): float32 max |dp| {r0['max_abs_err']:.3g} "
          f"(tol 1e-4), bf16 argmax agreement {r0['argmax_agree']:.6f} (tol 0.995)")
    for tag in ("f32", "bf16"):
        print(f"[split] (a) {tag}: peak memory a rank {per_rank('peak_' + tag)} GiB against "
              f"{r0['unsplit_peak_' + tag]:.2f} GiB unsplit; ms/forward a rank "
              f"{per_rank('ms_' + tag)} against {r0['unsplit_ms_' + tag]:.2f} unsplit "
              f"(host-inclusive; the two ranks share the card) on {smi}")
    print(f"[split] (b) PMF nuScenes train step float32, batch {NBT}, {NTH}x{NTW}, point "
          f"Lovász: loss terms within {r0['loss_rel_err']:.3g} (tol 1e-4) {r0['losses']}; "
          f"gradients {r0['grad_err']:.3g} of their norm, parameter by parameter at most "
          f"{r0['grad_err_each']:.3g} (two unsplit runs: {r0['grad_noise']:.3g} and "
          f"{r0['grad_noise_each']:.3g}; the unsplit step on the features times 1 + 2^-23: "
          f"{r0['grad_nudge']:.3g} and {r0['grad_nudge_each']:.3g}); BN running variances "
          f"within {r0['var_err']:.3g} of their norm (nudged: {r0['var_nudge']:.3g}); float64, "
          f"first item: loss terms within "
          f"{r0['loss_rel_err64']:.3g} (tol 1e-4), gradients {r0['grad_err64']:.3g} of their "
          f"norm, parameter by parameter at most {r0['grad_err64_each']:.3g} (tol 1e-3)")
    print(f"[split] (b) peak memory a rank {per_rank('peak_train')} GiB against "
          f"{r0['unsplit_peak_train']:.2f} GiB unsplit; ms/step a rank {per_rank('ms_train')} "
          f"against {r0['unsplit_ms_train']:.2f} unsplit (first step, host-inclusive) on {smi}")
    (lov, lov_each), (lov_nudge, lov_nudge_each) = (r0["grad_err_nolovasz"],
                                                    r0["grad_nudge_nolovasz"])
    print(f"[split] (b) float32 gradients of the split step from the unsplit one, of their "
          f"norm (all parameters; parameter by parameter at most): with the Lovász terms "
          f"{r0['grad_err']:.3g} ({r0['grad_err_each']:.3g}), the nudged unsplit step "
          f"{r0['grad_nudge']:.3g} ({r0['grad_nudge_each']:.3g}); without them (λ = 0, no "
          f"points) {lov:.3g} ({lov_each:.3g}), nudged {lov_nudge:.3g} ({lov_nudge_each:.3g}); "
          f"the split step with remat {r0['grad_err_remat'][0]:.3g} "
          f"({r0['grad_err_remat'][1]:.3g}), the unsplit step with remat "
          f"{r0['grad_remat_unsplit'][0]:.3g} ({r0['grad_remat_unsplit'][1]:.3g}) on {smi}")
    d = r0["dryrun"]
    print(f"[split] (c) dryrun step float64 at model {SPLIT_MODEL}: losses {d['loss_rel_err']:.3g}, "
          f"BN statistics {d['stats_abs_err']:.3g}, parameters {d['param_rel_err']:.3g} of "
          f"their norm, confusion equal {d['conf_equal']}")
    print(f"[split] launches over (a) and (b), both ranks: {json.dumps(launches)}; phase 12 "
          f"{time.perf_counter() - t0:.1f} s")
    if not r0["max_abs_err"] <= 1e-4 or not r0["argmax_agree"] >= 0.995:
        fail("[split] (a) the split eval forward differs from one process")
    if not (r0["loss_rel_err"] <= 1e-4 and r0["loss_rel_err64"] <= 1e-4
            and r0["grad_err64_each"] <= 1e-3):
        fail("[split] (b) the split train step differs from one process")
    if not (d["loss_rel_err"] <= dryrun.LOSS_RTOL and d["stats_abs_err"] <= dryrun.STATS_ATOL
            and d["param_rel_err"] <= dryrun.PARAM_RTOL and d["conf_equal"]):
        fail("[split] (c) the small step at model 2 differs from one process")
    if launches["rasterize_zbuffer"] == 0 or launches["zbuffer_keys"] == 0:
        fail(f"[split] a kernel of the split path was not launched: {launches}")
    return launches, r0


def remat_trainer(dev, opts, raw, remat: bool) -> dict:
    """The Trainer of `opts` (random weights from a seed) on the in-memory
    samples `raw`, with `remat` or without: epoch 0's means of the loss
    terms (2 steps), ms/step over 4 more steps (host-inclusive) and the peak
    device memory over the 6."""
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.train import Trainer

    opts = copy.deepcopy(opts)
    opts.config["remat"] = remat
    bt = opts.batch_size[0]
    torch.manual_seed(0)
    model = random_weights(build_model(opts), seed=0).to(dev)
    trainer = Trainer(opts, model, scan_reader(raw, 2 * bt), 2 * bt, scan_reader(raw, 2 * bt),
                      bt, dev, [0.0] + [1.0] * (opts.nclasses - 1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first = trainer.run(0, "Train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in (1, 2):
        trainer.run(epoch, "Train")
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) / 4 * 1e3, "peak": peak_gib(),
           "losses": {k: v for k, v in first.items() if k.startswith(("loss", "Loss"))}}
    if not all(np.isfinite(v) for v in out["losses"].values()):
        fail(f"[remat] (a) non-finite losses {first}")
    del trainer, model
    torch.cuda.empty_cache()
    return out


def remat_float64_item(dev) -> dict:
    """(b): one float64 PMF train step (base 32, dropout 0.2 from a seeded
    generator, point Lovász) on one full-width item of the KITTI train view
    (256x1024, fixed draws), with remat against without: the gradients'
    distance, the BN running statistics and the generator's state after the
    step."""
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.data.synthetic import make_inputs
    from pmf_tpu_torch.models import PMFNet, random_weights
    from pmf_tpu_torch.train import HybridOptimizer, LossConfig, make_pmf_train_step

    raw = make_inputs(np.random.default_rng(13), 1, N, H, W)
    with torch.no_grad():
        f, _, lab, pts = build_batch(*on(raw, dev), train_cfg(), True,
                                     aug_override=fixed_aug(1, dev), return_points=True)
    torch.manual_seed(0)
    base = random_weights(PMFNet(nclasses=20, base_channels=32), seed=0).double()
    base.dtype = torch.float64
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(base).to(dev)
        opt = HybridOptimizer(model, lambda step: 1e-3, 0.9, 1e-5)
        step = make_pmf_train_step(model, opt, LossConfig(alpha=tuple([0.0] + [1.0] * 19)),
                                   remat=remat)
        generator = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        aux = step(f.double(), lab, generator, pts)
        runs.append({"losses": {k: float(v) for k, v in aux.items()
                                if k not in ("conf", "conf_cam")},
                     "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                     "stats": {k: v.cpu() for k, v in model.state_dict().items()
                               if "running" in k},
                     "generator": generator.get_state(), "peak": peak_gib()})
        del model, opt, step
    off, on_ = runs
    return {"grads": grad_distance(on_["grads"], off["grads"]),
            "losses": max(abs(on_["losses"][k] - v) / max(abs(v), 1e-30)
                          for k, v in off["losses"].items()),
            "stats_equal": all(torch.equal(on_["stats"][k], v) for k, v in off["stats"].items()),
            "generator_equal": torch.equal(on_["generator"], off["generator"]),
            "peaks": (off["peak"], on_["peak"])}


def profile_dir_run(dev) -> dict:
    """(e): the Trainer with `profile_dir` (parallel/dryrun.py's tiny PMF
    scans on the card, 5 train iterations): its trace files, the labels of
    the iterations in them and the count of CUDA kernel events."""
    from pmf_tpu_torch.parallel import dryrun

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile_smoke")
    shutil.rmtree(root, ignore_errors=True)
    trainer = dryrun.tiny_trainer(10, 5, dev, config={"profile_dir": root})
    trainer.run(0, "Train")
    trainer.run(1, "Train")
    files = sorted(os.listdir(root))
    events = []
    for name in files:
        with open(os.path.join(root, name)) as fh:
            events += json.load(fh)["traceEvents"]
    labels = sorted({e.get("name", "") for e in events if "iteration" in e.get("name", "")})
    out = {"files": files, "labels": labels,
           "kernels": sum(e.get("cat") == "kernel" for e in events),
           "bytes": sum(os.path.getsize(os.path.join(root, n)) for n in files)}
    shutil.rmtree(root)
    return out


def remat_phase(dev, smi, split: dict) -> None:
    """Phase 13: remat on the card. (a) the PMF Trainer at 6(c)'s shapes
    (bf16, batch 8, 256x1024) and the EPMF Trainer at 7(d)'s (batch 2,
    320x1280), each without and with `remat`: peak memory, ms/step, and
    epoch 0's loss terms within 1e-4 of each other;
    the float32 PMF nuScenes step of 12(b) (batch 3, 640x960) without and
    with remat, from phase 12's unsplit runs; (b) remat_float64_item:
    gradients within 1e-10 of their norm, BN statistics and the generator's
    state equal; (c) from phase 12's two gloo ranks (data 1 x model 2): the
    float64 split step on the train batch's first item with remat against
    without, gradients, losses and BN variances within 1e-10; (e)
    profile_dir_run: one trace file with train iterations 2-4 and CUDA
    kernel events."""
    t0 = time.perf_counter()
    for name, (opts, raw), size in (("PMF", pmf_train_setup(), (TH, TW)),
                                    ("EPMF", epmf_train_setup(), (HE, WE))):
        off, on_ = remat_trainer(dev, opts, raw, False), remat_trainer(dev, opts, raw, True)
        err = max(abs(on_["losses"][k] - v) / max(abs(v), 1e-30) for k, v in off["losses"].items())
        bt = opts.batch_size[0]
        print(f"[remat] (a) {name}-ResNet34 Trainer bf16, batch {bt}, {size[0]}x{size[1]}: "
              f"peak {off['peak']:.2f} GiB without remat, {on_['peak']:.2f} GiB with it "
              f"(torch.cuda.max_memory_allocated); {off['ms']:.2f} against {on_['ms']:.2f} "
              f"ms/step (4 steps after 2, host-inclusive); epoch 0's loss terms within "
              f"{err:.3g} (tol 1e-4) on {smi}")
        if not err <= 1e-4:
            fail(f"[remat] (a) {name}: the loss terms with remat differ from those without: "
                 f"{off['losses']} against {on_['losses']}")
    print(f"[remat] (a) PMF nuScenes train step float32, batch {NBT}, {NTH}x{NTW} (phase 12, "
          f"unsplit): peak {split['unsplit_peak_train']:.2f} GiB without remat, "
          f"{split['unsplit_peak_train_remat']:.2f} GiB with it; "
          f"{split['unsplit_ms_train_again']:.2f} against {split['unsplit_ms_train_remat']:.2f} "
          f"ms (the second step of the process without remat, the fifth with it; each with the "
          f"model's build, host-inclusive) on {smi}")

    b = remat_float64_item(dev)
    print(f"[remat] (b) PMF-ResNet34 float64 train step on one {TH}x{TW} item, dropout 0.2, "
          f"remat against none: gradients {b['grads'][0]:.3g} of their norm (parameter by "
          f"parameter at most {b['grads'][1]:.3g}; tol 1e-10), losses {b['losses']:.3g}, BN "
          f"statistics equal {b['stats_equal']}, generator state equal {b['generator_equal']}; "
          f"peak {b['peaks'][0]:.2f} against {b['peaks'][1]:.2f} GiB on {smi}")
    if not (b["grads"][1] <= 1e-10 and b["losses"] <= 1e-10 and b["stats_equal"]
            and b["generator_equal"]):
        fail("[remat] (b) the float64 step with remat differs from the step without it")

    c = split["remat64"]
    print(f"[remat] (c) the split float64 step (data 1 x model 2, gloo, first item of "
          f"{NTH}x{NTW}) with remat against without: gradients {c['grads'][0]:.3g} of their "
          f"norm (parameter by parameter at most {c['grads'][1]:.3g}), losses "
          f"{c['losses']:.3g}, BN variances {c['var']:.3g} (tol 1e-10) on {smi}")
    if not (c["grads"][1] <= 1e-10 and c["losses"] <= 1e-10 and c["var"] <= 1e-10):
        fail("[remat] (c) the split step with remat differs from the split step without it")

    e = profile_dir_run(dev)
    print(f"[remat] (e) Trainer with profile_dir: {len(e['files'])} trace file(s) {e['files']} "
          f"({e['bytes']} bytes), labels {e['labels']}, {e['kernels']} CUDA kernel events on "
          f"{smi}")
    if (len(e["files"]) != 1 or e["kernels"] == 0
            or e["labels"] != [f"Train iteration {i}" for i in (2, 3, 4)]):
        fail("[remat] (e) the profile_dir trace is not one file of train iterations 2-4 with "
             "kernel events")
    print(f"[remat] phase 13 {time.perf_counter() - t0:.1f} s (phase 12's runs for (a) and (c) "
          "not included)")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = card_name()
    print(smi)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from pmf_tpu_torch.utils import disable_tf32

    disable_tf32()   # float32 comparisons below must not run convolutions in TF32

    from pmf_tpu_torch.data import PVConfig
    from pmf_tpu_torch.data.synthetic import make_inputs
    from pmf_tpu_torch.ops import kernels

    t_run = t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    print(so.with_suffix(".log").read_text().strip())

    dev = torch.device("cuda")
    cfg = PVConfig(canvas_h=H, canvas_w=W + 16, proj_h=H, proj_w=W, h_pad=7, w_pad=3,
                   n_points=N)
    raw = make_inputs(np.random.default_rng(0), B, N, H, W)
    batch = [torch.from_numpy(a).to(dev) for a in raw]

    entries = check_kernels(dev, cfg, batch, smi)
    aspp_rows = check_aspp(dev, smi)
    epilogue_rows = check_epilogue(dev, smi)
    epilogue_train_rows = check_epilogue_train(dev, smi)
    AsppWatch.install()
    check_reference(dev)
    timing: dict = {}
    launches = main_path(dev, cfg, batch, raw, smi)
    check_train_view(dev, batch)
    check_train_reference(dev)
    launches_train = full_width_train(dev, smi, timing)
    del batch

    cfg_e = epmf_cfg()
    raw_e = make_inputs(np.random.default_rng(1), B, NE, H, W)
    batch_e = [torch.from_numpy(a).to(dev) for a in raw_e]
    check_tight_box(batch_e, cfg_e)
    epmf_numbers = check_epmf_kernels(dev, cfg_e, batch_e, smi)
    check_epmf_reference(dev)
    launches_epmf = epmf_main_path(dev, cfg_e, batch_e, raw_e, smi)
    launches_epmf_train = epmf_train(dev, smi)
    del batch_e
    t_range = time.perf_counter()

    from pmf_tpu_torch.data.synthetic import make_range_inputs

    raw_r = make_range_inputs(np.random.default_rng(2), RB, RN, RN - 10000)
    batch_r = on(raw_r, dev)
    range_numbers = {"zbuffer_keys": check_range_kernels(dev, batch_r, smi),
                     "rasterize_zbuffer": {}}   # K2 is not on the range path
    check_salsanext_reference(dev)
    launches_salsanext = salsanext_main_path(dev, batch_r, raw_r, smi)
    launches_salsanext_train = salsanext_train(dev, smi)
    t_nusc = time.perf_counter()
    del batch_r
    nusc_numbers = nuscenes_phase(dev, smi)
    t_a2d2 = time.perf_counter()
    a2d2_numbers = a2d2_sensat_phase(dev, smi)
    t_cli = time.perf_counter()
    launches_cli = cli_train(dev, smi, timing["ms_step"])
    launches_ddp = nccl_world1(dev, smi)
    t_split = time.perf_counter()
    launches_split, split = split_phase(dev, smi)
    t_remat = time.perf_counter()
    remat_phase(dev, smi, split)
    t_seen = time.perf_counter()
    aspp_seen = check_aspp_seen(dev)
    print(f"[time] phases 1-7 {t_range - t_run:.1f} s, phase 8 {t_nusc - t_range:.1f} s, phase 9 "
          f"{t_a2d2 - t_nusc:.1f} s, phase 10 {t_cli - t_a2d2:.1f} s, phase 11 "
          f"{t_split - t_cli:.1f} s, phase 12 {t_remat - t_split:.1f} s, phase 13 "
          f"{t_seen - t_remat:.1f} s, phase 15 "
          f"{time.perf_counter() - t_seen:.1f} s (the build included in phase 2)")
    range_keys = ("range_max_abs_err", "range_ms", "range_device_ms", "range_plain_ms",
                  "range_bound_ms", "range_bound_by", "range_library_ms")
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["launches_train"] = launches_train[e["name"]]
        e["launches_epmf"] = launches_epmf[e["name"]]
        e["launches_epmf_train"] = launches_epmf_train[e["name"]]
        e["launches_salsanext"] = launches_salsanext[e["name"]]
        e["launches_salsanext_train"] = launches_salsanext_train[e["name"]]
        e.update(epmf_numbers[e["name"]])
        e.update({k: range_numbers[e["name"]].get(k) for k in range_keys})
        e.update(nusc_numbers[e["name"]])
        e.update(a2d2_numbers[e["name"]])
        e["launches_cli_train"] = launches_cli[e["name"]]
        e["launches_ddp_train"] = launches_ddp[e["name"]]
        e["launches_split"] = launches_split[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "launches_train", "launches_epmf",
            "launches_epmf_train", "launches_salsanext", "launches_salsanext_train",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "epmf_max_abs_err", "epmf_ms", "epmf_device_ms", "epmf_plain_ms", "epmf_bound_ms",
            "epmf_bound_by", "epmf_library_ms", *range_keys, "launches_nusc",
            "launches_nusc_train", "launches_nusc_epmf", "launches_nusc_epmf_train",
            "launches_nusc_salsanext",
            "nusc_max_abs_err", "nusc_ms", "nusc_device_ms", "nusc_plain_ms", "nusc_bound_ms",
            "nusc_bound_by", "nusc_library_ms", "launches_a2d2", "launches_a2d2_train",
            "launches_cli_train", "launches_ddp_train", "launches_split",
            *(p + k for p in ("a2d2_", "a2d2_val_")
              for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")))
    aspp_entry = {"name": "aspp_branches", "route": "cuda", "source": "pmf_tpu_torch/csrc/aspp.cu",
                  "replaces": None,
                  "launches_aspp": {"pmf_eval": launches["aspp_branches"],
                                    "epmf_eval": launches_epmf["aspp_branches"]},
                  "shapes": aspp_rows, "seen": aspp_seen}
    epilogue_entry = {"name": "conv_epilogue", "route": "cuda",
                      "source": "pmf_tpu_torch/csrc/conv_epilogue.cu", "replaces": None,
                      "launches_epilogue": {"pmf_eval": launches["conv_epilogue"],
                                            "epmf_eval": launches_epmf["conv_epilogue"]},
                      "shapes": epilogue_rows}
    epilogue_train_entry = {"name": "bn_epilogue", "route": "cuda",
                            "source": "pmf_tpu_torch/csrc/conv_epilogue_train.cu",
                            "replaces": None,
                            "launches_train_step": {"pmf": BN_TRAIN_STEP["PMFNet"],
                                                    "epmf": BN_TRAIN_STEP["EPMFNet"]},
                            "shapes": epilogue_train_rows}
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]
                      + [aspp_entry, epilogue_entry, epilogue_train_entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
