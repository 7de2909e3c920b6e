"""Timing on the card, and the least time the card could take.

`time_ms` (host-inclusive: CUDA events around many calls in a row) and
`device_ms` (device only: many calls captured in one CUDA graph, replayed)
time a function on the card; `bound_ms` is the larger of its bytes over the
H100's memory rate and its operations over its float32 rate (NVIDIA's data
sheet for the H100 SXM at 700 W). `rasterize_bytes` and `keys_bytes` count
what K2 and K1 must move: each input read once, each output written once.
`rasterize_numbers` and `keys_numbers` give a kernel's times on its inputs
beside its plain version's, the library call's and its bound.

Used by `chip_smoke.py`'s kernel table; everything here needs a card but
the byte counts and `bound_ms`.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def card_name() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (the first card's)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def bound_ms(n_bytes: float, n_ops: float):
    """(the least ms the card could take for `n_bytes` moved and `n_ops`
    float32 operations, "bytes" or "operations": whichever bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rasterize_bytes(keep, f: int, h: int, w: int) -> tuple[int, int]:
    """K2's (bytes, operations) on points `keep` [B, N] with `f` values each
    into an h x w canvas: rows, cols, depth (int32, f32), keep and the values
    read once; the canvas and its mask written once; one key a kept point,
    one store a canvas value."""
    b, n = keep.shape
    return (b * n * (4 + 4 + 4 + 1 + 4 * f) + b * h * w * (4 * f + 1),
            int(keep.sum()) + b * h * w * f)


def keys_bytes(pix, kept: int, h: int, w: int) -> tuple[int, int]:
    """K1's (bytes, operations) on the packed keys `pix` [B, N]: the pixels
    and keys read once, the key image written once; one atomic a kept
    point."""
    return pix.numel() * 8 + pix.shape[0] * h * w * 4, kept


def rasterize_numbers(rows, cols, depth, keep, vals, h: int, w: int) -> dict:
    """K2's times on these inputs (host-inclusive and on the device), its
    plain version's and the library call's (`scatter_reduce_` "amin" of the
    64-bit (dq << 32) | index keys, then a gather of the winners' rows,
    checked to compute the same function), and its bound."""
    from ..ops import rasterize

    b, n = rows.shape
    f = vals.shape[-1]
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
        rows_ = vals.gather(1, win[..., None].expand(-1, -1, f))
        return torch.where(hit[..., None], rows_, 0.0), hit

    lib_c, lib_m = library_rasterize()
    want_c, want_m = rasterize.rasterize_zbuffer_plain(*args)
    if not (torch.equal(lib_c.reshape(want_c.shape), want_c)
            and torch.equal(lib_m.reshape(want_m.shape), want_m)):
        raise RuntimeError("the library yardstick for rasterize_zbuffer computes another "
                           "function")
    bnd, by = bound_ms(*rasterize_bytes(keep, f, h, w))
    return {"ms": time_ms(lambda: rasterize.rasterize_zbuffer(*args)),
            "device_ms": device_ms(lambda: rasterize.rasterize_zbuffer(*args)),
            "plain_ms": time_ms(lambda: rasterize.rasterize_zbuffer_plain(*args), iters=5),
            "bound_ms": bnd, "bound_by": by, "library_ms": time_ms(library_rasterize)}


def keys_numbers(pix, key, h: int, w: int, kept: int):
    """K1's times on these keys ([B, N]: one scan, or a batch), its plain
    version's and the library call's (`full` + `scatter_reduce_` "amin",
    checked to compute the same function), and its bound (`kept` atomics);
    and the library call itself."""
    from ..ops import zbuffer

    pix64 = pix.long()
    b = pix.shape[0]

    def library_keys():
        out = torch.full((b, h * w + 1), zbuffer.IMAX, dtype=torch.int32, device=pix.device)
        return out.scatter_reduce_(1, pix64, key, "amin")

    if not torch.equal(library_keys()[:, :h * w].reshape(b, h, w),
                       zbuffer.zbuffer_keys_plain(pix, key, h, w)):
        raise RuntimeError("the library yardstick for zbuffer_keys computes another function")
    bnd, by = bound_ms(*keys_bytes(pix, kept, h, w))
    return {"ms": time_ms(lambda: zbuffer.zbuffer_keys(pix, key, h, w)),
            "device_ms": device_ms(lambda: zbuffer.zbuffer_keys(pix, key, h, w)),
            "plain_ms": time_ms(lambda: zbuffer.zbuffer_keys_plain(pix, key, h, w)),
            "bound_ms": bnd, "bound_by": by, "library_ms": time_ms(library_keys)}, library_keys
