"""K1: scatter-min of packed z-buffer keys into a key image.

Counterpart of the Pallas TPU kernel `pmf_tpu/ops/pallas/zbuffer.py:
zbuffer_pallas`. The CUDA kernel is `csrc/zbuffer_keys.cu` (one int32
atomicMin per point; bound by bytes, about 0.7 us per eval scan on an H100,
so launch latency dominates). `zbuffer_keys_plain` is the same function in
plain PyTorch: the CPU path, and the yardstick the kernel is held to.
"""
from __future__ import annotations

import torch

from . import kernels

IMAX = 2**31 - 1


def zbuffer_keys_plain(pix: torch.Tensor, key: torch.Tensor, H: int,
                       W: int) -> torch.Tensor:
    """Scatter-min of `key` at flat pixel `pix` ([B, N] int32 each).

    Pixels outside [0, H*W) (the H*W sentinel) are dropped. Returns the
    [B, H, W] int32 key image, INT32_MAX where no point landed.
    """
    B = pix.shape[0]
    hw = H * W
    p = torch.where((pix >= 0) & (pix < hw), pix, hw).long()
    out = torch.full((B, hw + 1), IMAX, dtype=torch.int32, device=pix.device)
    out.scatter_reduce_(1, p, key, "amin")
    return out[:, :hw].reshape(B, H, W)


def zbuffer_keys(pix: torch.Tensor, key: torch.Tensor, H: int,
                 W: int) -> torch.Tensor:
    """`zbuffer_keys_plain` on the CPU; on CUDA tensors, one launch of the
    K1 kernel for the whole batch (it raises rather than fall back)."""
    if pix.device.type == "cpu":
        return zbuffer_keys_plain(pix, key, H, W)
    B, N = pix.shape
    for t, name in ((pix, "pix"), (key, "key")):
        kernels.check(t, name, torch.int32, (B, N), pix.device)
    lib = kernels.load()
    with torch.cuda.device(pix.device):
        out = torch.full((B, H * W), IMAX, dtype=torch.int32, device=pix.device)
        rc = lib.pmf_zbuffer_keys(pix.data_ptr(), key.data_ptr(), out.data_ptr(),
                                  B, N, H * W,
                                  torch.cuda.current_stream().cuda_stream)
    kernels.raise_on_error(rc, "zbuffer_keys")
    zbuffer_keys.launches += 1
    return out.reshape(B, H, W)


zbuffer_keys.launches = 0
