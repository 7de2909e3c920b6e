"""K1: scatter-min of packed z-buffer keys into a key image.

Counterpart of the Pallas TPU kernel `pmf_tpu/ops/pallas/zbuffer.py:
zbuffer_pallas`. The CUDA kernel is `csrc/zbuffer_keys.cu`: one cooperative
launch that writes INT32_MAX over the image, waits at a grid-wide barrier,
then does one int32 atomicMin per point. It is bound by bytes, about 0.7 us
per eval scan on an H100, so the host's work to issue a call dominates.
`zbuffer_keys_plain` is the same function in plain PyTorch: the CPU path,
and the yardstick the kernel is held to.
"""
from __future__ import annotations

import torch

from ..utils.spans import span
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
    K1 kernel for the whole batch (it raises rather than fall back). The
    launch is short on the device, so the host's work per call is kept to
    the input checks, one allocation and one C call. The whole call is the
    span pmf.k1 (`utils/spans.py`)."""
    with span("pmf.k1"):
        if pix.is_cpu:
            return zbuffer_keys_plain(pix, key, H, W)
        B, N = pix.shape
        for t, name in ((pix, "pix"), (key, "key")):
            kernels.check(t, name, torch.int32, (B, N), pix.device)
        out = pix.new_empty((B, H, W))
        kernels.launch("pmf_zbuffer_keys", pix.device, pix.data_ptr(), key.data_ptr(),
                       out.data_ptr(), B, N, H * W)
        zbuffer_keys.launches += 1
        return out


zbuffer_keys.launches = 0
