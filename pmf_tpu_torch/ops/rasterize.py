"""K2: z-buffer rasterization of point features into dense canvases.

Counterpart of the Pallas TPU kernel `pmf_tpu/ops/pallas/tile_fill.py:
rasterize_zbuffer_pallas`. Each pixel takes the point with the smallest
quantized depth dq = int(clip(depth / depth_quant, 0, 65535)), the lowest
point index on ties, and gets that point's F values and an occupancy bit.

The CUDA kernel is `csrc/rasterize.cu`: a 64-bit atomicMin of
(dq << 32) | index per point, then one writer per pixel. It is bound by
bytes: about 104 MB at the eval batch (B = 8, N = 32768, 384x1232, F = 6),
so about 31 us on an H100. `rasterize_zbuffer_plain` is the same function
in plain PyTorch (a stable sort on (pixel, dq)): the CPU path, and the
yardstick the kernel is held to.
"""
from __future__ import annotations

import torch

from . import kernels
from .scatter import flat_pixels

DQ_MAX = 2**16 - 1


def rasterize_zbuffer_plain(rows, cols, depth, keep, values, H: int, W: int,
                            depth_quant: float = 1.0 / 64.0):
    """rows/cols [B, N] int, depth [B, N] f32, keep [B, N] bool,
    values [B, N, F] f32 → (canvas [B, H, W, F] f32, zeros at empty pixels;
    mask [B, H, W] bool)."""
    B, N, F = values.shape
    dev = values.device
    pix = flat_pixels(rows, cols, keep, H, W).long()
    dq = (depth.float() / depth_quant).clamp(0, DQ_MAX).long()
    # the first entry of each pixel's run in a stable (pixel, dq) order
    order = torch.sort(pix * (DQ_MAX + 1) + dq, dim=1, stable=True).indices
    spix = pix.gather(1, order)
    won = spix < H * W
    won[:, 1:] &= spix[:, 1:] != spix[:, :-1]
    b = torch.arange(B, device=dev)[:, None].expand(B, N)[won]
    canvas = torch.zeros((B, H * W, F), dtype=torch.float32, device=dev)
    mask = torch.zeros((B, H * W), dtype=torch.bool, device=dev)
    canvas[b, spix[won]] = values[b, order[won]].float()
    mask[b, spix[won]] = True
    return canvas.reshape(B, H, W, F), mask.reshape(B, H, W)


def rasterize_zbuffer(rows, cols, depth, keep, values, H: int, W: int,
                      depth_quant: float = 1.0 / 64.0):
    """`rasterize_zbuffer_plain` on the CPU; on CUDA tensors, one launch of
    the K2 kernel for the whole batch (it raises rather than fall back)."""
    if values.device.type == "cpu":
        return rasterize_zbuffer_plain(rows, cols, depth, keep, values, H, W,
                                       depth_quant)
    B, N, F = values.shape
    dev = values.device
    for t, name, dtype in ((rows, "rows", torch.int32), (cols, "cols", torch.int32),
                           (depth, "depth", torch.float32), (keep, "keep", torch.bool)):
        kernels.check(t, name, dtype, (B, N), dev)
    kernels.check(values, "values", torch.float32, (B, N, F), dev)
    lib = kernels.load()
    with torch.cuda.device(dev):
        keys = torch.full((B, H * W), -1, dtype=torch.int64, device=dev)
        canvas = torch.empty((B, H, W, F), dtype=torch.float32, device=dev)
        mask = torch.empty((B, H, W), dtype=torch.bool, device=dev)
        rc = lib.pmf_rasterize_zbuffer(
            rows.data_ptr(), cols.data_ptr(), depth.data_ptr(), keep.data_ptr(),
            values.data_ptr(), keys.data_ptr(), canvas.data_ptr(), mask.data_ptr(),
            B, N, H, W, F, depth_quant, torch.cuda.current_stream().cuda_stream)
    kernels.raise_on_error(rc, "rasterize_zbuffer")
    rasterize_zbuffer.launches += 1
    return canvas, mask


rasterize_zbuffer.launches = 0
