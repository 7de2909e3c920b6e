"""Drive the PyTorch port (pmf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:
  1. device: the card's name and power limit (nvidia-smi), torch's version;
  2. build: compile the CUDA kernels from pmf_tpu_torch/csrc for sm_90a;
  3. kernels: each kernel on the eval path's own inputs (batch 8 of
     32768-point synthetic scans, 384x1232, 6 features), with forced ties,
     held to its plain PyTorch version exactly; times of the kernel, the
     plain version and one PyTorch library call for the same function;
  4. reference: the port in float32 on the card against the port on the CPU
     (which the tests hold to pmf_tpu) at a small size, with random weights
     under which the probabilities depend on the input;
  5. main path: PMF-ResNet34 (20 classes, base 32, bf16 compute, random
     weights from a seed) on batched eval at full width, build_batch →
     PMFNet → argmax, then one scan through the Inference.run loop of
     tools/infer_kitti (per-scan view → forward → KNN lift → IoU). The
     kernels' launch counts are read around this phase alone, and both
     must be > 0. Prints the batched path's scans/s.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a CUDA card the script exits 1 and
prints neither.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W, B, N, F = 384, 1232, 8, 32768, 6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Device time of one call of `fn`: CUDA events around `iters` calls in a
    row, divided by the count (a call timed alone on an idle card would
    also count the host's time to enqueue it); the median of `repeats`."""
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


def check_kernels(dev, cfg, batch):
    from pmf_tpu_torch.data.perspective_pipeline import view_geometry
    from pmf_tpu_torch.ops import rasterize, zbuffer
    from pmf_tpu_torch.ops.scatter import packed_keys

    rows, cols, keep, depth, vals, _ = view_geometry(*batch, cfg)
    rows, cols, depth, keep = force_ties(rows, cols, depth, keep, seed=1)
    entries = []

    # K2 at the batched path's shapes
    args = (rows, cols, depth, keep, vals.contiguous(), H, W)
    canvas, mask = rasterize.rasterize_zbuffer(*args)
    torch.cuda.synchronize()
    want_c, want_m = rasterize.rasterize_zbuffer_plain(*args)
    if not (torch.equal(mask, want_m) and torch.equal(canvas, want_c)):
        fail(f"rasterize_zbuffer differs from its plain version: "
             f"{(mask != want_m).sum().item()} mask bits, max canvas error "
             f"{(canvas - want_c).abs().max().item()}")
    err = (canvas - want_c).abs().max().item()
    print(f"[kernels] rasterize_zbuffer == plain at B={B} N={N} {H}x{W} F={F}: "
          f"{int(mask.sum())} occupied pixels, max_abs_err {err}")

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
    if not (torch.equal(lib_c.reshape(canvas.shape), canvas)
            and torch.equal(lib_m.reshape(mask.shape), mask)):
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
        "plain_ms": time_ms(lambda: rasterize.rasterize_zbuffer_plain(*args), iters=5),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(library_rasterize),
    })

    # K1 at the per-scan path's shapes (one scan), and once for the batch
    pix, key, _ = packed_keys(rows, cols, depth, keep, H, W, 1 / 64)
    for b_sz in (B, 1):
        p, k = pix[:b_sz].contiguous(), key[:b_sz].contiguous()
        got = zbuffer.zbuffer_keys(p, k, H, W)
        torch.cuda.synchronize()
        want = zbuffer.zbuffer_keys_plain(p, k, H, W)
        if not torch.equal(got, want):
            fail(f"zbuffer_keys differs from its plain version at B={b_sz}: "
                 f"{(got != want).sum().item()} pixels")
        print(f"[kernels] zbuffer_keys == plain at B={b_sz} N={N} {H}x{W}: "
              f"{int((got != zbuffer.IMAX).sum())} occupied pixels")
    p1, k1 = pix[:1].contiguous(), key[:1].contiguous()
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
        "max_abs_err": float((got.long() - want.long()).abs().max().item()),
        "ms": time_ms(lambda: zbuffer.zbuffer_keys(p1, k1, H, W)),
        "plain_ms": time_ms(lambda: zbuffer.zbuffer_keys_plain(p1, k1, H, W)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(library_keys),
    })
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
        plain = _build_batch(*batch, cfg, rasterize.rasterize_zbuffer_plain)
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

    entries = check_kernels(dev, cfg, batch)
    check_reference(dev)
    launches = main_path(dev, cfg, batch, raw, smi)
    for e in entries:
        e["launches"] = launches[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
