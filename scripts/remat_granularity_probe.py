"""Peak device memory and time of the PMF KITTI train step at four remat
granularities, on the card: none; one checkpoint around the whole forward;
one around each stream (camera encoder, lidar stream, camera decoder); and
one around each stage (`remat=True`, models/layers.py: remat_stage).

    PYTHONPATH=. python scripts/remat_granularity_probe.py

The step is chip_smoke.py's 6(c) shapes: PMF-ResNet34 (random weights from
a seed), bf16, batch 8, the 256x1024 train view of synthetic scans with
point Lovász and dropout from a seeded generator, the hybrid optimizer.
Each granularity runs 2 warm-up steps and 4 timed ones (host-inclusive
ms/step) after the peak statistics are reset; the loss of its first step
is printed beside the others' (the same function at every granularity).
"""
from __future__ import annotations

import contextlib
import copy
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

import chip_smoke as cs
from pmf_tpu_torch.data import build_batch
from pmf_tpu_torch.data.synthetic import make_inputs
from pmf_tpu_torch.models import PMFNet, random_weights
from pmf_tpu_torch.models.layers import _Recompute
from pmf_tpu_torch.train import HybridOptimizer, LossConfig, pmf_losses
from pmf_tpu_torch.utils import disable_tf32


def checkpointed(fn, *args, generator=None):
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _Recompute(generator)))


def per_stream(model, pcd, img, g):
    """PMFNet.forward with one checkpoint a stream."""
    pcd = pcd.permute(0, 3, 1, 2).to(model.dtype)
    img = img.permute(0, 3, 1, 2).to(model.dtype)
    feats = checkpointed(lambda x: model.camera_stream_encoder(x, g), img, generator=g)
    lidar = checkpointed(lambda x, *f: model.lidar_stream(x, list(f), g), pcd, *feats,
                         generator=g)
    camera = checkpointed(lambda *f: model.camera_stream_decoder(list(f)), *feats)
    return lidar.permute(0, 2, 3, 1), camera.permute(0, 2, 3, 1)


FORWARDS = {
    "none": lambda m, p, i, g: m(p, i, g),
    "whole forward": lambda m, p, i, g: checkpointed(lambda a, b: m(a, b, g), p, i, generator=g),
    "per stream": per_stream,
    "per stage": lambda m, p, i, g: m(p, i, g, remat=True),
}


def main():
    if not torch.cuda.is_available():
        sys.exit("remat_granularity_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    disable_tf32()
    dev = torch.device("cuda")
    raw = make_inputs(np.random.default_rng(3), cs.B, cs.N, cs.H, cs.W)
    with torch.no_grad():
        f, _, lab, pts = build_batch(*cs.on(raw, dev), cs.train_cfg(), True,
                                     aug_override=cs.fixed_aug(cs.B, dev), return_points=True)
    torch.manual_seed(0)
    base = random_weights(PMFNet(nclasses=20, base_channels=32, dtype=torch.bfloat16), seed=0)
    cfg = LossConfig(alpha=tuple([0.0] + [1.0] * 19))
    print(smi)
    for name, forward in FORWARDS.items():
        model = copy.deepcopy(base).to(dev).train()
        opt = HybridOptimizer(model, lambda step: 1e-3, 0.9, 1e-5)
        g = torch.Generator(device=dev).manual_seed(7)

        def step():
            opt.zero_grad()
            preds = forward(model, f[..., :5], f[..., 5:8], g)
            total, _ = pmf_losses(*preds, lab, cfg, pts)
            total.backward()
            opt.step()
            return total

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = step().item()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 4 * 1e3
        print(f"{name:>14}: peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"{ms:.2f} ms/step (4 after 2, host-inclusive), first loss {first:.6f} on {smi}")
        del model, opt
    print(f"PMF-ResNet34 bf16 train step, batch {cs.B}, {cs.TH}x{cs.TW}, point Lovász")


if __name__ == "__main__":
    main()
