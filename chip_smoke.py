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
     (c) are `launches_train` in the kernel line.

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


def force_ties(rows, cols, depth, keep, seed: int):
    """Copy some points onto other points' pixel and depth (equal dq at a
    higher or lower index), drop some, and push some off the image."""
    rng = np.random.default_rng(seed)
    rows, cols, depth, keep = (t.clone() for t in (rows, cols, depth, keep))
    n = rows.shape[1]
    src = torch.from_numpy(rng.integers(0, n, (rows.shape[0], n // 8))).to(rows.device)
    dst = torch.from_numpy(rng.integers(0, n, (rows.shape[0], n // 8))).to(rows.device)
    for t in (rows, cols, depth, keep):
        t.scatter_(1, dst, t.gather(1, src))
    keep[:, :100] = False
    rows[:, 100:120] = H + 5
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


def hold_rasterize(label: str, rows, cols, depth, keep, values):
    """K2 on these points, held to its plain version bit for bit; returns
    the max abs error."""
    from pmf_tpu_torch.ops import rasterize

    args = (rows, cols, depth, keep, values, H, W)
    canvas, mask = rasterize.rasterize_zbuffer(*args)
    torch.cuda.synchronize()
    want_c, want_m = rasterize.rasterize_zbuffer_plain(*args)
    if not (torch.equal(mask, want_m) and torch.equal(canvas, want_c)):
        fail(f"rasterize_zbuffer differs from its plain version ({label}): "
             f"{(mask != want_m).sum().item()} mask bits, "
             f"{(canvas != want_c).sum().item()} canvas values")
    b, n = rows.shape
    print(f"[kernels] rasterize_zbuffer == plain ({label}) at B={b} N={n} {H}x{W} "
          f"F={values.shape[-1]}: {int(mask.sum())} occupied pixels")
    return (canvas - want_c).abs().max().item()


def hold_keys(label: str, pix, key):
    """K1 on these keys, held to its plain version bit for bit; returns the
    max abs error."""
    from pmf_tpu_torch.ops import zbuffer

    got = zbuffer.zbuffer_keys(pix, key, H, W)
    torch.cuda.synchronize()
    want = zbuffer.zbuffer_keys_plain(pix, key, H, W)
    if not torch.equal(got, want):
        fail(f"zbuffer_keys differs from its plain version ({label}): "
             f"{(got != want).sum().item()} pixels")
    b, n = pix.shape
    print(f"[kernels] zbuffer_keys == plain ({label}) at B={b} N={n} {H}x{W}: "
          f"{int((got != zbuffer.IMAX).sum())} occupied pixels")
    return float((got.long() - want.long()).abs().max().item())


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

    pix64 = torch.where(keep, rows.clamp(0, H - 1).long() * W + cols.clamp(0, W - 1).long(), H * W)
    idx = torch.arange(N, device=dev)

    def library_rasterize():
        dq = (depth / (1 / 64)).clamp(0, 65535).long()
        best = torch.full((B, H * W + 1), 2**63 - 1, dtype=torch.int64, device=dev)
        best.scatter_reduce_(1, pix64, (dq << 32) | idx, "amin")
        hit = best[:, :H * W] != 2**63 - 1
        win = (best[:, :H * W] & 0xFFFFFFFF).clamp(max=N - 1)
        rows_ = vals.gather(1, win[..., None].expand(-1, -1, F))
        return torch.where(hit[..., None], rows_, 0.0), hit

    lib_c, lib_m = library_rasterize()
    want_c, want_m = rasterize.rasterize_zbuffer_plain(*args)
    if not (torch.equal(lib_c.reshape(want_c.shape), want_c)
            and torch.equal(lib_m.reshape(want_m.shape), want_m)):
        fail("the library yardstick for rasterize_zbuffer computes another function")
    kept = int(keep.sum())
    bnd, by = bound_ms(B * N * (4 + 4 + 4 + 1 + 4 * F) + B * H * W * (4 * F + 1),
                       kept + B * H * W * F)
    entries.append({
        "name": "rasterize_zbuffer", "route": "cuda",
        "source": "pmf_tpu_torch/csrc/rasterize.cu",
        "replaces": "pmf_tpu/ops/pallas/tile_fill.py:148",
        "max_abs_err": err,
        "ms": time_ms(lambda: rasterize.rasterize_zbuffer(*args)),
        "device_ms": device_ms(lambda: rasterize.rasterize_zbuffer(*args)),
        "plain_ms": time_ms(lambda: rasterize.rasterize_zbuffer_plain(*args), iters=5),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(library_rasterize),
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
    p1_64 = p1.long()

    def library_keys():
        out = torch.full((1, H * W + 1), zbuffer.IMAX, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(1, p1_64, k1, "amin")

    if not torch.equal(library_keys()[:, :H * W].reshape(1, H, W), zbuffer.zbuffer_keys_plain(p1, k1, H, W)):
        fail("the library yardstick for zbuffer_keys computes another function")
    bnd, by = bound_ms(N * 8 + H * W * 4, int(keep[0].sum()))
    entries.append({
        "name": "zbuffer_keys", "route": "cuda",
        "source": "pmf_tpu_torch/csrc/zbuffer_keys.cu",
        "replaces": "pmf_tpu/ops/pallas/zbuffer.py:45",
        "max_abs_err": err,
        "ms": time_ms(lambda: zbuffer.zbuffer_keys(p1, k1, H, W)),
        "device_ms": device_ms(lambda: zbuffer.zbuffer_keys(p1, k1, H, W)),
        "plain_ms": time_ms(lambda: zbuffer.zbuffer_keys_plain(p1, k1, H, W)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(library_keys),
    })
    for e in entries:
        print(f"[timing] {e['name']}: ms {e['ms']:.5g} (host-inclusive), device_ms "
              f"{e['device_ms']:.5g} (CUDA graph), bound {e['bound_ms']:.5g} "
              f"({e['bound_by']}), plain {e['plain_ms']:.5g}, library "
              f"{e['library_ms']:.5g} on {smi}")

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
    from pmf_tpu_torch.ops import argmax_last

    h, w = 64, 160
    torch.manual_seed(6)
    cfg = PVConfig(canvas_h=h, canvas_w=w + 16, proj_h=h, proj_w=w, n_points=2048)
    raw = make_inputs(np.random.default_rng(5), 2, 2048, h, w)
    model = random_weights(PMFNet(nclasses=20, base_channels=8), seed=6)
    outs = []
    for d in (torch.device("cpu"), dev):
        m = model.to(d)
        with torch.inference_mode():
            f, mask, lab = build_batch(*(torch.from_numpy(a).to(d) for a in raw), cfg)
            lidar, cam = m(f[..., :5], f[..., 5:8])
        outs.append([t.cpu() for t in (f, mask, lab, lidar, cam, argmax_last(lidar))])
    (f0, m0, l0, p0, c0, a0), (f1, m1, l1, p1, c1, a1) = outs
    f_err = (f0 - f1).abs().max().item()
    f_ulp = ulp(f0.abs().max())
    if f_err > 4 * f_ulp or not (torch.equal(m0, m1) and torch.equal(l0, l1)):
        fail(f"the card's mask or labels differ from the CPU's, or its features "
             f"by {f_err} (tolerance 4 ulp = {4 * f_ulp})")
    err = max((p0 - p1).abs().max().item(), (c0 - c1).abs().max().item())
    top2 = p0.topk(2, dim=-1).values
    clear = top2[..., 0] - top2[..., 1] > 1e-4
    n_classes = a0.unique().numel()
    if err > 1e-4 or not torch.equal(a0[clear], a1[clear]):
        fail(f"float32 probabilities on the card differ from the CPU's by {err}")
    if clear.float().mean() <= 0.9 or n_classes < 2:
        fail(f"the reference run cannot tell forwards apart: top-2 margin > 1e-4 at "
             f"{clear.float().mean().item():.3f} of the pixels, {n_classes} classes")
    print(f"[reference] card vs CPU at 2x{h}x{w}: mask/labels exact, features max "
          f"abs diff {f_err:.3g} = {f_err / f_ulp:.2f} ulp of the largest feature "
          f"{f0.abs().max().item():.4g} (tolerance 4 ulp), probabilities max abs diff "
          f"{err:.3g} (tolerance 1e-4); argmax margin > 1e-4 at "
          f"{clear.float().mean().item():.4f} of the pixels, {n_classes} classes")


def main_path(dev, cfg, batch, raw, smi):
    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.data.perspective_pipeline import _build_batch
    from pmf_tpu_torch.models import PMFNet, random_weights
    from pmf_tpu_torch.ops import argmax_last, rasterize, zbuffer
    from pmf_tpu_torch.tools.infer_kitti import Inference

    torch.manual_seed(0)
    model = random_weights(PMFNet(nclasses=20, base_channels=32, image_backbone="resnet34",
                              dtype=torch.bfloat16), seed=0).to(dev)
    sensor = {"canvas_h": cfg.canvas_h, "canvas_w": cfg.canvas_w, "proj_h": H, "proj_w": W,
              "h_pad": cfg.h_pad, "w_pad": cfg.w_pad, "n_points": N}
    opts = Options(nclasses=20, base_channels=32, compute_dtype="bfloat16",
                   config={"sensor": sensor, "post": {"KNN": {"params": {
                       "knn": 5, "search": 5, "sigma": 1.0, "cutoff": 1.0}}}})
    scan = {k: a[0] for k, a in zip(
        ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w"), raw)}
    inference = Inference(opts, model, lambda i: scan, 1, dev, ignore=[0], use_knn=True)

    def batched(c):
        f, m, lab = build_batch(*batch, c)
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
    print(f"[main] launches on the main path: {json.dumps(launches)}")
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path was not launched: {launches}")

    if lidar.shape != (B, H, W, 20) or not torch.isfinite(lidar).all():
        fail(f"lidar probabilities: shape {tuple(lidar.shape)}, finite {bool(torch.isfinite(lidar).all())}")
    if not torch.isfinite(f).all() or f.shape != (B, H, W, 8):
        fail("features are not finite or have the wrong shape")
    if int(pred.min()) < 0 or int(pred.max()) >= 20 or int(lab.min()) < 0 or int(lab.max()) >= 20:
        fail("labels out of range")
    n_classes = pred.unique().numel()
    if n_classes < 2:
        fail("the batched path predicts one class everywhere")
    if not all(np.isfinite(v) for t in ("pixel", "point") for v in report[t].values()):
        fail(f"Inference.run report is not finite: {report}")
    print(f"[main] batched: {int(m.sum())} occupied pixels, {n_classes} classes "
          f"predicted ({int(pred.min())}..{int(pred.max())}); one scan through Inference.run: "
          f"point mIoU {report['point']['mIoU']:.4f}, pixel mIoU {report['pixel']['mIoU']:.4f}")

    with torch.inference_mode():
        plain = _build_batch(*batch, cfg, fill=rasterize.rasterize_zbuffer_plain)
        if not all(torch.equal(a, b) for a, b in zip((f, m, lab), plain)):
            fail("the batched path gives other features, mask or labels with the plain fill")
        print("[main] batched path: kernel fill == plain fill (features, mask, labels)")

        for _ in range(2):
            batched(cfg)
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched(cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"[main] batched eval build_batch+PMFNet+argmax, batch {B}, {H}x{W}, bf16: "
          f"{B / med:.2f} scans/s (median of {len(times)} batches: {med * 1e3:.2f} ms, "
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


def train_step_run(model, dev, batch):
    """One train step (make_pmf_train_step, hybrid optimizer) of `model` on
    `batch` moved to `dev`: (aux, gradients by name, BN running statistics)."""
    from pmf_tpu_torch.train import HybridOptimizer, LossConfig, make_pmf_train_step

    feature, label, points = (t.to(dev) if torch.is_tensor(t) else tuple(x.to(dev) for x in t)
                              for t in batch)
    opt = HybridOptimizer(model, lambda step: 1e-3, 0.9, 1e-5)
    cfg = LossConfig(alpha=tuple([0.0] + [1.0] * 19))
    aux = make_pmf_train_step(model, opt, cfg)(feature, label, None, points)
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
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
    batch = (f, lab, pts)
    model = random_weights(PMFNet(nclasses=20, base_channels=8, dropout_rate=0.0), seed=9)
    model64 = copy.deepcopy(model).double()
    model64.dtype = torch.float64
    cpu = torch.device("cpu")
    aux_c, g_c, s_c = train_step_run(copy.deepcopy(model), cpu, batch)
    aux_d, g_d, s_d = train_step_run(copy.deepcopy(model).to(dev), dev, batch)
    _, g64_c, _ = train_step_run(copy.deepcopy(model64), cpu, batch)
    _, g64_d, _ = train_step_run(copy.deepcopy(model64).to(dev), dev, batch)

    loss_err = max(abs(aux_d[k].item() - aux_c[k].item()) / abs(aux_c[k].item())
                   for k in aux_c if k not in ("conf", "conf_cam"))
    stat_err = max(((s_d[k] - s_c[k]).norm() / s_c[k].norm()).item() for k in s_c)
    if loss_err > 1e-4 or stat_err > 1e-5:
        fail(f"train step: losses differ by {loss_err:.3g} relative (tolerance 1e-4), BN "
             f"statistics by {stat_err:.3g} (tolerance 1e-5)")
    worst = 0.0
    for k, g in g64_c.items():
        err, norm = (g64_d[k] - g).norm().item(), g.norm().item()
        worst = max(worst, err / (1e-3 * norm + 1e-7))
        if err > 1e-3 * norm + 1e-7:
            fail(f"float64 train step gradient {k}: card vs CPU {err:.3g}, norm {norm:.3g}")
    e64, e32 = grad_errors(g64_c, g64_d), grad_errors(g_c, g_d)
    print(f"[train] (b) f32 train step card vs CPU at 2x48x96, base 8: losses max rel diff "
          f"{loss_err:.3g} (tol 1e-4), BN running stats max diff {stat_err:.3g} of each "
          f"tensor's norm (tol 1e-5); the same step in float64: {len(e64)} gradients within "
          f"1e-3 of their norm + 1e-7 (the worst at {worst:.3g} of that), median |dg|/|g| "
          f"{e64[len(e64) // 2]:.3g}; the float32 gradients for comparison: median |dg|/|g| "
          f"{e32[len(e32) // 2]:.3g}, max {e32[-1]:.3g}")


def profile_step(step, smi, top: int = 12):
    """torch.profiler over one trainer step (host batch → view → step): the
    device's busy time against the step's wall time, and the PyTorch
    operations whose own kernels take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in events
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 reverse=True)
    print(f"[trace] train step: device busy {busy:.2f} ms of {wall_ms:.2f} ms wall (profiled) "
          f"on {smi}; the operations whose kernels take the most device time:")
    for t, n, k in ops[:top]:
        print(f"[trace]   device {t:9.3f} ms  x{n:<5d} {k}")


def scan_reader(raw, n_pool: int):
    """reader(i) → the numpy sample dict of synthetic scan i mod n_pool."""
    keys = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
    return lambda i: {k: a[i % n_pool] for k, a in zip(keys, raw)}


def full_width_train(dev, smi):
    """(c): the Trainer at full width; returns the kernels' launch counts
    over its train and validation runs."""
    from pmf_tpu_torch.config import Options
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.data.synthetic import make_inputs
    from pmf_tpu_torch.models import build_model, random_weights
    from pmf_tpu_torch.ops import rasterize, zbuffer
    from pmf_tpu_torch.train import Trainer, pmf_losses
    from pmf_tpu_torch.train.trainer import batches

    sensor = {"canvas_h": H, "canvas_w": W + 16, "proj_h": H, "proj_w": W, "proj_ht": TH,
              "proj_wt": TW, "h_pad": 7, "w_pad": 3, "n_points": N}
    opts = Options(config={"sensor": sensor, "augmentation": {"img_jitter": [0.4, 0.4, 0.4]}},
                   compute_dtype="bfloat16", batch_size=(B, B), n_epochs=5, warmup_epochs=1)
    raw = make_inputs(np.random.default_rng(3), 2 * B, N, H, W)
    reader = scan_reader(raw, 2 * B)
    torch.manual_seed(0)
    model = random_weights(build_model(opts), seed=0).to(dev)
    trainer = Trainer(opts, model, reader, 2 * B, reader, B, dev, [0.0] + [1.0] * 19)
    before = {k: v.clone() for k, v in model.state_dict().items()}

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

    losses = [v for r in runs + [val] for k, v in r.items() if k.startswith(("loss", "Loss"))]
    if not all(np.isfinite(losses)) or len(losses) != 6 * len(runs + [val]):
        fail(f"train path: non-finite or missing losses {runs + [val]}")
    after = model.state_dict()
    params = [k for k, _ in model.named_parameters()]
    stats = [k for k in after if "running" in k]
    moved = sum(not torch.equal(before[k], after[k]) for k in params)
    moved_stats = sum(not torch.equal(before[k], after[k]) for k in stats)
    if moved < len(params) // 2 or moved_stats != len(stats):
        fail(f"train path: {moved}/{len(params)} parameters and {moved_stats}/{len(stats)} BN "
             "statistics changed")
    if train_conf != (2 * B * TH * TW,) * 2 or val_conf != (B * H * W,) * 2:
        fail(f"confusion matrices sum to {train_conf} (train) and {val_conf} (validation), "
             f"not the {2 * B * TH * TW} and {B * H * W} labelled pixels")
    if min(launches.values()) == 0:
        fail(f"a kernel of the train path was not launched: {launches}")

    # one more step, split by CUDA events (the trainer's pieces, in its order)
    x = [torch.from_numpy(a[:B]).to(dev) for a in raw]
    g, opt = trainer.generator, trainer.optimizer
    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        with torch.no_grad():
            f, _, lab, pts = build_batch(*x, trainer.pv_cfg, True, g, return_points=True)
        ev[1].record()
        model.train()
        opt.zero_grad()
        lidar, cam = model(f[..., :5], f[..., 5:8], g)
        ev[2].record()
        total, _ = pmf_losses(lidar, cam, lab, trainer.loss_cfg, pts)
        ev[3].record()
        total.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
    split = [statistics.median(c) for c in zip(*splits)]
    names = ("view", "forward", "loss", "backward", "optimizer")
    profile_step(lambda: trainer._step(next(batches(reader, 2 * B, B, True)), True), smi)
    print(f"[train] (c) Trainer, PMF-ResNet34 bf16, batch {B}, {TH}x{TW} crop, {N} points, "
          f"point Lovász: {ms_step:.2f} ms/step = {B / ms_step * 1e3:.2f} train scans/s "
          f"(8 steps after 2 warm-up, host-inclusive) on {smi}")
    print("[train] (c) one step split (CUDA events, median of 3): "
          + ", ".join(f"{n} {t:.2f} ms" for n, t in zip(names, split))
          + f" = {sum(split):.2f} ms on {smi}")
    print(f"[train] (c) peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {smi}")
    print(f"[train] (c) losses finite; {moved}/{len(params)} parameters and {moved_stats}/"
          f"{len(stats)} BN statistics changed; confusion matrices sum to the labelled pixels "
          f"({train_conf[0]:.0f} train, {val_conf[0]:.0f} validation); last train loss "
          f"{runs[-1]['Loss']:.4f}, validation mIoU {val['IOU']:.4f}")
    print(f"[train] launches on the train path: {json.dumps(launches)}")
    return launches


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

    t0 = time.perf_counter()
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
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["launches_train"] = launches_train[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "launches_train", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
