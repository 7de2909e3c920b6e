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
  4. reference: the port in float32 on the card against the port on the CPU
     (which the tests hold to pmf_tpu) at a small size, with random weights
     under which the probabilities depend on the input;
  5. main path: PMF-ResNet34 (20 classes, base 32, bf16 compute, random
     weights from a seed) on batched eval at full width, build_batch →
     PMFNet → argmax, then one scan through the Inference.run loop of
     tools/infer_kitti (per-scan view → forward → KNN lift → IoU). The
     kernels' launch counts are read around this phase alone, and both
     must be > 0. Prints the batched path's scans/s;
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
     scans/s; (d) the SalsaNext Trainer at full width (batch 8, the yaml's
     point augmentation, reversed yaw bounds included), 2 warm-up and 8
     timed steps and one validation pass, checked as (6c); ms/step, the
     step split, the peak memory (`launches_salsanext_train`). TF32 is off
     for the whole run, so float32 convolutions run in float32.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a CUDA card the script exits 1 and
prints neither.
"""
import copy
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W, B, N, F = 384, 1232, 8, 32768, 6
TH, TW = 256, 1024          # the train view (bench.py:67, pmf_kitti.yaml proj_ht/proj_wt)
HE, WE, NE = 320, 1280, 131072  # EPMF's V2 view and point buffer (epmf_kitti.yaml PVconfig)
BT, BV = 2, 4               # EPMF's train and validation batches (epmf_kitti.yaml batch_size)
RH, RW, RN, RB = 64, 2048, 131072, 8  # SalsaNext's range view and batch (salsanext_kitti.yaml)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Host-inclusive time of one call of `fn`: CUDA events around `iters`
    calls in a row, divided by the count (a call timed alone on an idle card
    would also count the host's time to enqueue it); the median of
    `repeats`. Where the host's work per call exceeds the device's, this is
    the host's rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def device_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device time of one call of `fn`: `iters` calls captured into one CUDA
    graph, replayed between CUDA events, divided by the count; the median of
    `repeats` replays. The host's per-call work ran once, at capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def rasterize_numbers(rows, cols, depth, keep, vals, h: int, w: int) -> dict:
    """K2's times on these inputs (host-inclusive and on the device), its
    plain version's and the library call's (`scatter_reduce_` "amin" of the
    64-bit (dq << 32) | index keys, then a gather of the winners' rows,
    checked to compute the same function), and its bound."""
    from pmf_tpu_torch.ops import rasterize

    b, n = rows.shape
    dev = rows.device
    args = (rows, cols, depth, keep, vals, h, w)
    pix64 = torch.where(keep, rows.clamp(0, h - 1).long() * w + cols.clamp(0, w - 1).long(), h * w)
    idx = torch.arange(n, device=dev)

    def library_rasterize():
        dq = (depth / (1 / 64)).clamp(0, 65535).long()
        best = torch.full((b, h * w + 1), 2**63 - 1, dtype=torch.int64, device=dev)
        best.scatter_reduce_(1, pix64, (dq << 32) | idx, "amin")
        hit = best[:, :h * w] != 2**63 - 1
        win = (best[:, :h * w] & 0xFFFFFFFF).clamp(max=n - 1)
        rows_ = vals.gather(1, win[..., None].expand(-1, -1, F))
        return torch.where(hit[..., None], rows_, 0.0), hit

    lib_c, lib_m = library_rasterize()
    want_c, want_m = rasterize.rasterize_zbuffer_plain(*args)
    if not (torch.equal(lib_c.reshape(want_c.shape), want_c)
            and torch.equal(lib_m.reshape(want_m.shape), want_m)):
        fail("the library yardstick for rasterize_zbuffer computes another function")
    bnd, by = bound_ms(b * n * (4 + 4 + 4 + 1 + 4 * F) + b * h * w * (4 * F + 1),
                       int(keep.sum()) + b * h * w * F)
    return {"ms": time_ms(lambda: rasterize.rasterize_zbuffer(*args)),
            "device_ms": device_ms(lambda: rasterize.rasterize_zbuffer(*args)),
            "plain_ms": time_ms(lambda: rasterize.rasterize_zbuffer_plain(*args), iters=5),
            "bound_ms": bnd, "bound_by": by, "library_ms": time_ms(library_rasterize)}


def keys_numbers(pix, key, h: int, w: int, kept: int):
    """K1's times on these keys ([B, N]: one scan, or a batch), its plain
    version's and the library call's (`full` + `scatter_reduce_` "amin",
    checked to compute the same function), and its bound (`kept` atomics);
    and the library call itself."""
    from pmf_tpu_torch.ops import zbuffer

    pix64 = pix.long()
    b = pix.shape[0]

    def library_keys():
        out = torch.full((b, h * w + 1), zbuffer.IMAX, dtype=torch.int32, device=pix.device)
        return out.scatter_reduce_(1, pix64, key, "amin")

    if not torch.equal(library_keys()[:, :h * w].reshape(b, h, w),
                       zbuffer.zbuffer_keys_plain(pix, key, h, w)):
        fail("the library yardstick for zbuffer_keys computes another function")
    bnd, by = bound_ms(pix.numel() * 8 + b * h * w * 4, kept)
    return {"ms": time_ms(lambda: zbuffer.zbuffer_keys(pix, key, h, w)),
            "device_ms": device_ms(lambda: zbuffer.zbuffer_keys(pix, key, h, w)),
            "plain_ms": time_ms(lambda: zbuffer.zbuffer_keys_plain(pix, key, h, w)),
            "bound_ms": bnd, "bound_by": by, "library_ms": time_ms(library_keys)}, library_keys


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


def eval_path(dev, tag, name, model, opts, build, build_with_fill, cfg, batch, raw, size, smi):
    """Batched eval (`build` → `model` → argmax) and one scan through the
    Inference.run loop (KNN on), with both kernels' launch counts read
    around them; the batched path against the same with the plain fill; its
    scans/s. Returns the launch counts."""
    from pmf_tpu_torch.ops import argmax_last, rasterize, zbuffer
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

    zbuffer.zbuffer_keys.launches = 0
    rasterize.rasterize_zbuffer.launches = 0
    with torch.inference_mode():
        f, m, lab, lidar, pred = batched(cfg)
        report = inference.run()
    torch.cuda.synchronize()
    launches = {"zbuffer_keys": zbuffer.zbuffer_keys.launches,
                "rasterize_zbuffer": rasterize.rasterize_zbuffer.launches}
    print(f"{tag} launches on the main path: {json.dumps(launches)}")
    if min(launches.values()) == 0:
        fail(f"{tag} a kernel of the main path was not launched: {launches}")

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


def train_step_run(model, dev, batch, mt_sigma=None):
    """One train step of `model` on `batch` moved to `dev` (PMFNet and
    EPMFNet: make_pmf_train_step, hybrid optimizer, with `mt_sigma` the
    multi-task loss, σ in the AdamW group; SalsaNext: its step and adamw):
    (aux, gradients by name, BN running statistics)."""
    from pmf_tpu_torch.models import SalsaNext
    from pmf_tpu_torch.train import (HybridOptimizer, LossConfig, adamw, make_pmf_train_step,
                                     make_salsanext_train_step)

    feature, label, points = (t.to(dev) if torch.is_tensor(t) else
                              None if t is None else tuple(x.to(dev) for x in t) for t in batch)
    extra = [] if mt_sigma is None else [torch.nn.Parameter(mt_sigma.to(dev, copy=True))]
    cfg = LossConfig(alpha=tuple([0.0] + [1.0] * 19), use_mtloss=bool(extra))
    if isinstance(model, SalsaNext):
        aux = make_salsanext_train_step(model, adamw(model, lambda step: 1e-3), cfg)(feature, label)
    else:
        opt = HybridOptimizer(model, lambda step: 1e-3, 0.9, 1e-5, extra=extra)
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


def hold_train_step(dev, tag, model, batch, mt_sigma=None, stats_in_float64=False):
    """One train step of `model` on `batch` on the card against the CPU,
    held as `check_train_reference` says; with `stats_in_float64` the BN
    statistics are held in the float64 step too (the float32 ones printed)."""
    model64 = copy.deepcopy(model).double()
    model64.dtype = torch.float64
    sigma64 = None if mt_sigma is None else mt_sigma.double()
    cpu = torch.device("cpu")
    aux_c, g_c, s_c = train_step_run(copy.deepcopy(model), cpu, batch, mt_sigma)
    aux_d, g_d, s_d = train_step_run(copy.deepcopy(model).to(dev), dev, batch, mt_sigma)
    _, g64_c, s64_c = train_step_run(copy.deepcopy(model64), cpu, batch, sigma64)
    _, g64_d, s64_d = train_step_run(copy.deepcopy(model64).to(dev), dev, batch, sigma64)

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


def scan_reader(raw, n_pool: int):
    """reader(i) → the numpy sample dict of synthetic scan i mod n_pool (the
    perspective views' keys, or the range view's for 3 arrays)."""
    keys = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
    return lambda i: {k: a[i % n_pool] for k, a in zip(keys, raw)}


def full_width_train(dev, smi):
    """(c): the Trainer at full width; returns the kernels' launch counts
    over its train and validation runs."""
    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data.synthetic import make_inputs

    sensor = {"canvas_h": H, "canvas_w": W + 16, "proj_h": H, "proj_w": W, "proj_ht": TH,
              "proj_wt": TW, "h_pad": 7, "w_pad": 3, "n_points": N}
    opts = Options(config={"sensor": sensor, "augmentation": {"img_jitter": [0.4, 0.4, 0.4]}},
                   compute_dtype="bfloat16", batch_size=(B, B), n_epochs=5, warmup_epochs=1)
    raw = make_inputs(np.random.default_rng(3), 2 * B, N, H, W)
    return train_path(dev, smi, "[train] (c)", "PMF-ResNet34", opts, raw, (TH, TW), (H, W),
                      ("rasterize_zbuffer", "zbuffer_keys"))


def train_path(dev, smi, tag, net, opts, raw, size_train, size_val, kernels_of_path):
    """The Trainer of `opts` on the in-memory scans `raw` (2 train batches
    an epoch, 1 validation batch): 2 warm-up and 8 timed steps, one
    validation pass, the checks of (6c) (and σ trained, with the
    multi-task loss), a step split by CUDA events and a profiled step.
    Returns the kernels' launch counts over the train and validation runs;
    each of `kernels_of_path` must have been launched."""
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.ops import rasterize, zbuffer
    from pmf_tpu_torch.train import Trainer, pmf_losses, salsanext_losses
    from pmf_tpu_torch.train.trainer import batches

    bt, bv = opts.batch_size
    (th, tw), (vh, vw) = size_train, size_val
    reader = scan_reader(raw, 2 * bt)
    torch.manual_seed(0)
    model = random_weights(build_model(opts), seed=0).to(dev)
    trainer = Trainer(opts, model, reader, 2 * bt, reader, bv, dev, [0.0] + [1.0] * 19)
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
    if min(launches[k] for k in kernels_of_path) == 0:
        fail(f"{tag} a kernel of the train path was not launched: {launches}")

    # one more step, split by CUDA events (the trainer's pieces, in its order)
    x = {k: torch.from_numpy(a).to(dev) for k, a in next(batches(reader, bt, bt, False)).items()}
    g, opt = trainer.generator, trainer.optimizer
    splits = []
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
    names = ("view", "forward", "loss", "backward", "optimizer")
    profile_step(lambda: trainer._step(next(batches(reader, 2 * bt, bt, True)), True), smi)
    lovasz = "point" if trainer.point_lovasz else "image-domain"
    print(f"{tag} Trainer, {net} {opts.compute_dtype}, batch {bt}, {th}x{tw} crop, "
          f"{raw[0].shape[1]} points, {lovasz} Lovász"
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
                     build_v2_batch, _build_v2_batch, cfg, batch, raw, (HE, WE), smi)


def epmf_train(dev, smi):
    """7(d): the EPMF Trainer at full width (epmf_kitti.yaml: bf16, batch 2
    for training and 4 for validation, multi-task loss, image-domain
    Lovász)."""
    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data.synthetic import make_inputs

    pv = {"canvas_h": H, "canvas_w": W + 16, "proj_h": HE, "proj_w": WE, "proj_ht": HE,
          "proj_wt": WE, "n_points": NE}
    opts = Options(config={"PVconfig": pv, "augmentation": {"img_jitter": [0.4, 0.4, 0.4]},
                           "use_mtloss": True, "point_lovasz": False},
                   net_type="EPMFNet", compute_dtype="bfloat16", batch_size=(BT, BV),
                   n_epochs=5, warmup_epochs=1)
    raw = make_inputs(np.random.default_rng(4), 2 * BT, NE, H, W)
    return train_path(dev, smi, "[epmf] (d)", "EPMF-ResNet34", opts, raw, (HE, WE), (HE, WE),
                      ("rasterize_zbuffer",))


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
    from pmf_tpu_torch.ops import argmax_last, rasterize, zbuffer
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

    zbuffer.zbuffer_keys.launches = 0
    rasterize.rasterize_zbuffer.launches = 0
    with torch.inference_mode():
        f, m, lab, pred, am = batched()
        report = inference.run()
    torch.cuda.synchronize()
    launches = {"zbuffer_keys": zbuffer.zbuffer_keys.launches,
                "rasterize_zbuffer": rasterize.rasterize_zbuffer.launches}
    print(f"[salsanext] (c) launches on the SalsaNext eval path: {json.dumps(launches)}")
    if launches["zbuffer_keys"] == 0:
        fail(f"[salsanext] (c) K1 was not launched on the SalsaNext eval path: {launches}")
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
                      (RH, RW), (RH, RW), ("zbuffer_keys",))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # float32 comparisons below must not run convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

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
    check_reference(dev)
    launches = main_path(dev, cfg, batch, raw, smi)
    check_train_view(dev, batch)
    check_train_reference(dev)
    launches_train = full_width_train(dev, smi)
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
    print(f"[time] phases 1-7 {t_range - t_run:.1f} s, phase 8 {time.perf_counter() - t_range:.1f} s "
          "(the build included in phase 2)")
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
    keys = ("name", "route", "source", "replaces", "launches", "launches_train", "launches_epmf",
            "launches_epmf_train", "launches_salsanext", "launches_salsanext_train",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "epmf_max_abs_err", "epmf_ms", "epmf_device_ms", "epmf_plain_ms", "epmf_bound_ms",
            "epmf_bound_by", "epmf_library_ms", *range_keys)
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
