"""The spatial split: the image rows of a model group's samples spread over
its ranks (counterpart of `pmf_tpu/parallel/mesh.py:
spatial_batch_sharding` and `shard_batch(spatial=True)`, for which XLA puts
in the halo exchanges). Its purpose is memory: activations too large for
one device (nuScenes' 896×1600) are held a block of rows a rank.

A row-split tensor is this rank's block [N, C, h, W] of a tensor of H rows:
global rows [lo, hi) with b = ceil(H / M), lo = min(m·b, H), hi = min(lo +
b, H) for model rank m of M (`block_rows`). The blocks are even where M
divides H; deep stages can have fewer rows than ranks, and then the last
blocks are short or empty.

Each spatial op (`rows_op`) computes its own output rows [lo', hi') (the
same rule on the output's height) from the input rows they read, fetched
from the ranks that hold them, whatever their distance: a window can reach
past a neighbour's whole block (ASPP's dilation-18 3×3 on a 20-row map split
in two). Global rows outside [0, H) are the op's padding: zeros, or -inf for
a max pool. A fetch is one all-reduce over the model group of a buffer that
holds every rank's foreign rows, each written by its owner and zero
elsewhere (gloo runs only broadcast and all-reduce on CUDA tensors; NCCL
runs the same code across cards). Its backward pass is the transpose: each
rank writes the gradients of the rows it fetched, the all-reduce carries
them to their owners, and each owner adds them to its rows.

A block does not carry its global height, so the split records the height
of each (local rows, width) it has seen: the inputs of `split_rows` and
every op's output. In these nets one width has one height within a step; a
second height for the same (rows, width) raises. Put a fresh split in force
for each step (`Mesh.split()`). With none in force, every function here is
the one-process computation.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import _ACTIVE


def active():
    """The `RowSplit` in force, or None."""
    return _ACTIVE.get()


def block_rows(H: int, M: int, m: int) -> tuple[int, int]:
    """Global rows [lo, hi) of block m of a tensor of H rows split M ways."""
    b = -(-H // M)
    lo = min(m * b, H)
    return lo, min(lo + b, H)


def comm_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a buffer crosses the group in: float32 and float64 as they
    are, the rest (bfloat16, integers) as float32 or float64, exactly."""
    if dtype in (torch.float32, torch.float64):
        return dtype
    return torch.float32 if dtype.is_floating_point else torch.float64


class RowSplit:
    """The row split over `mesh`'s model group, in force inside `with`."""

    def __init__(self, mesh):
        self.mesh, self.group = mesh, mesh.model_group
        self.m, self.M = mesh.model_index, mesh.model
        self._heights: dict = {}
        self._tokens: list = []

    def __enter__(self):
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tokens.pop())

    def rows(self, H: int, m: int | None = None) -> tuple[int, int]:
        return block_rows(H, self.M, self.m if m is None else m)

    def register(self, h: int, w: int, H: int) -> None:
        known = self._heights.setdefault((h, w), H)
        if known != H:
            raise ValueError(f"row split: blocks of {h} rows and width {w} belong to tensors of "
                             f"{known} and {H} rows; put a fresh split in force for each step")

    def height(self, h: int, w: int) -> int:
        try:
            return self._heights[(h, w)]
        except KeyError:
            raise ValueError(f"row split: no tensor with blocks of {h} rows and width {w} came "
                             "through split_rows or a split op") from None


def height(x: torch.Tensor, dim: int = 2) -> int:
    """The global row count of `x`, whose rows are at `dim` (and columns at
    dim + 1): its own with no split in force."""
    split = active()
    return x.shape[dim] if split is None else split.height(x.shape[dim], x.shape[dim + 1])


def split_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of the rows (at `dim`) of `x`, which every rank of
    the model group holds whole (a batch view, a label canvas)."""
    split = active()
    if split is None:
        return x
    lo, hi = split.rows(x.shape[dim])
    split.register(hi - lo, x.shape[dim + 1], x.shape[dim])
    return x.narrow(dim, lo, hi - lo).contiguous()


@torch.no_grad()
def gather_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole tensor of which `x` is this rank's block of rows (at
    `dim`), on every rank of the model group (no gradient)."""
    split = active()
    if split is None:
        return x
    H = height(x, dim)
    lo, hi = split.rows(H)
    shape = list(x.shape)
    shape[dim] = H
    buf = x.new_zeros(shape, dtype=comm_dtype(x.dtype))
    buf.narrow(dim, lo, hi - lo).copy_(x)
    dist.all_reduce(buf, group=split.group)
    return buf.to(x.dtype)


class _ModelSum(torch.autograd.Function):
    """Sum over the model group; the backward pass sums the gradients over
    it too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the model group (`t` itself with no split in
    force); the gradient flows back to every rank's `t`."""
    split = active()
    return t if split is None else _ModelSum.apply(t, split.group)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean over H and W, keepdim: under the split the sum over the model
    group (in float32 at least) divided by the global count."""
    if active() is None:
        return x.mean(dim=(2, 3), keepdim=True)
    s = model_sum(x.to(torch.promote_types(x.dtype, torch.float32)).sum(dim=(2, 3), keepdim=True))
    return (s / (height(x) * x.shape[3])).to(x.dtype)


def _segments(H: int, M: int, needs) -> tuple[list, int]:
    """The exchange buffer's layout: (rank, g0, g1, offset) for each run of
    global rows [g0, g1) that rank needs and does not hold, and the total."""
    segs, off = [], 0
    for r, (a, b) in enumerate(needs):
        lo, hi = block_rows(H, M, r)
        for g0, g1 in ((a, min(b, lo)), (max(a, hi), b)):
            if g1 > g0:
                segs.append((r, g0, g1, off))
                off += g1 - g0
    return segs, off


class _Fetch(torch.autograd.Function):
    """Global rows [a, b) of a row-split [N, C, h, W] tensor on this rank,
    from whichever ranks hold them (one all-reduce over the model group)."""

    @staticmethod
    def forward(ctx, x, plan):
        m, lo, hi, a, b, segs, total, group = plan
        ctx.plan, ctx.x_shape = plan, x.shape
        N, C, _, W = x.shape
        buf = x.new_zeros((N, C, total, W), dtype=comm_dtype(x.dtype))
        for r, g0, g1, off in segs:
            i0, i1 = max(g0, lo), min(g1, hi)
            if r != m and i1 > i0:
                buf[:, :, off + i0 - g0:off + i1 - g0] = x[:, :, i0 - lo:i1 - lo]
        dist.all_reduce(buf, group=group)
        pieces = {g0: buf[:, :, off:off + g1 - g0] for r, g0, g1, off in segs if r == m}
        i0, i1 = max(a, lo), min(b, hi)
        if i1 > i0:
            pieces[i0] = x[:, :, i0 - lo:i1 - lo]
        if not pieces:
            return x.new_zeros((N, C, 0, W))
        return torch.cat([pieces[g].to(x.dtype) for g in sorted(pieces)], 2)

    @staticmethod
    def backward(ctx, grad):
        m, lo, hi, a, b, segs, total, group = ctx.plan
        N, C, h, W = ctx.x_shape
        buf = grad.new_zeros((N, C, total, W), dtype=comm_dtype(grad.dtype))
        for r, g0, g1, off in segs:
            if r == m:
                buf[:, :, off:off + g1 - g0] = grad[:, :, g0 - a:g1 - a]
        dist.all_reduce(buf, group=group)
        gx = grad.new_zeros((N, C, h, W))
        i0, i1 = max(a, lo), min(b, hi)
        if i1 > i0:
            gx[:, :, i0 - lo:i1 - lo] += grad[:, :, i0 - a:i1 - a]
        for r, g0, g1, off in segs:
            i0, i1 = max(g0, lo), min(g1, hi)
            if r != m and i1 > i0:
                gx[:, :, i0 - lo:i1 - lo] += buf[:, :, off + i0 - g0:off + i1 - g0].to(gx.dtype)
        return gx, None


def fetch_rows(x: torch.Tensor, H: int, needs, fill: float = 0.0) -> torch.Tensor:
    """This rank's rows [a, b) = needs[m] of the row-split `x` (H rows, at
    dim 2), where needs[r] are the rows that rank r reads (every rank passes
    the same list); rows outside [0, H) are `fill`. The exchange runs only
    when some rank needs rows it does not hold, the same choice on every
    rank."""
    split = active()
    m = split.m
    clip = lambda a, b: (min(max(a, 0), H), max(min(max(b, 0), H), min(max(a, 0), H)))
    clipped = [clip(a, b) for a, b in needs]
    segs, total = _segments(H, split.M, clipped)
    lo, hi = split.rows(H)
    a, b = clipped[m]
    if total:
        block = _Fetch.apply(x, (m, lo, hi, a, b, segs, total, split.group))
    else:
        block = x[:, :, max(a - lo, 0):max(b - lo, 0)]
    a_raw, b_raw = needs[m]
    top, bottom = max(0, min(b_raw, 0) - a_raw), max(0, b_raw - max(a_raw, H))
    if top == 0 and bottom == 0:
        return block
    shape = list(x.shape)
    pads = []
    for n in (top, bottom):
        shape[2] = n
        pads.append(x.new_full(shape, fill))
    return torch.cat([pads[0], block, pads[1]], 2)


def rows_op(x: torch.Tensor, H_out: int, need, fn, start, fill: float = 0.0,
            min_rows: int = 1) -> torch.Tensor:
    """An op along the rows of the row-split `x` [N, C, h, W]: this rank's
    output rows [lo', hi') of H_out. `need(lo', hi')` gives the global input
    rows [a, b) they read (a window may reach outside [0, H): those rows are
    `fill`), `fn(block)` applies the op, with no row padding, to those rows,
    and `start(a)` is the global output row of fn's first row. A rank with
    no output rows runs fn on `min_rows` rows of `fill` and keeps none of
    them, so that its autograd graph, and the collectives in it, are the
    other ranks'."""
    split = active()
    H = height(x)
    outs = [split.rows(H_out, r) for r in range(split.M)]
    needs = [need(lo, hi) if hi > lo else (0, 0) for lo, hi in outs]
    block = fetch_rows(x, H, needs, fill)
    lo, hi = outs[split.m]
    if hi > lo:
        y = fn(block)
        s = start(needs[split.m][0])
        y = y[:, :, lo - s:hi - s]
    else:
        shape = list(x.shape)
        shape[2] = min_rows
        y = fn(torch.cat([block, x.new_full(shape, fill)], 2))[:, :, :0]
    split.register(y.shape[2], y.shape[3], H_out)
    return y


def window_op(x: torch.Tensor, k: int, s: int, d: int, p: int, fn,
              fill: float = 0.0) -> torch.Tensor:
    """`rows_op` for a window along the rows (kernel k, stride s, dilation
    d, padding p, as a convolution or a pool has them); fn applies the op
    with no row padding."""
    H_out = (height(x) + 2 * p - d * (k - 1) - 1) // s + 1
    return rows_op(x, H_out, lambda lo, hi: (lo * s - p, (hi - 1) * s - p + d * (k - 1) + 1),
                   fn, lambda a: (a + p) // s, fill, d * (k - 1) + 1)
