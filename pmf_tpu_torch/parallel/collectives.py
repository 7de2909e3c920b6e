"""The reductions that make W processes compute one global-batch step.

Each of the W processes holds `batch_size[0]` rows of the global batch.
While a process group is up, every quantity that pmf_tpu takes over the
global batch is taken over all processes here: BN statistics, the loss
terms' sums and counts, the Lovász ranking, the random draws, the
confusion matrices and the gradients. With no group up each function is
the one-process computation, so the same code runs alone.

Gradients. Every process computes the same global loss L through
`global_sum`, whose backward pass sums the incoming gradients over the
processes. So a process's parameter gradient is W times the part of ∂L/∂θ
that flows through its own rows, and `average_gradients` (the sum over
processes divided by W) gives every process ∂L/∂θ. A tensor used only
after the reductions (the multi-task σ) already gets the whole ∂L/∂σ on
every process and is not averaged.

Under a (data, model) mesh with its row split in force (`parallel/spatial.py`)
each rank holds a block of rows of its data group's samples: a per-pixel sum
over all processes is still each pixel once, but the per-rank element counts
differ (`global_sum_count` sums them), the Lovász gathers are of uneven
widths (`col_layout`), the draws are one a data group (`rand_rows`), and a
parameter's gradient on a rank is the part through the rows that rank
computed, so the average over all processes is again ∂L/∂θ.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .mesh import _ACTIVE, data_world, world
from .spatial import comm_dtype


def data_parallel() -> bool:
    """True while a process group is up."""
    return dist.is_available() and dist.is_initialized()


class _GlobalSum(torch.autograd.Function):
    """Sum over the processes; its backward pass sums the incoming gradients
    over the processes too (each process's input reaches every process's
    output)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the processes (`t` itself with no group up). The
    gradient flows back to every process's `t` when `t` requires one."""
    return _GlobalSum.apply(t) if data_parallel() else t


def global_count(n: int) -> int:
    """A per-process element count (equal on every process: the shapes
    are static) over all processes."""
    return n * world()[1]


def global_sum_count(t: torch.Tensor, n: int):
    """(the sum of `t` over the processes, the sum of the per-process
    element counts n): `(global_sum(t), global_count(n))` unless a row split
    is in force, whose blocks can hold uneven counts; then n crosses in the
    same all-reduce as t, as a tensor of t's dtype."""
    if _ACTIVE.get() is None:
        return global_sum(t), global_count(n)
    both = global_sum(torch.cat([t.reshape(-1), t.new_full((1,), n)]))
    return both[:-1].reshape(t.shape), both[-1]


@dataclass(frozen=True)
class ColLayout:
    """Where each process's columns go in a gather under a row split: the
    slot widths in order, this process's slot, and whether it writes it."""
    sizes: tuple
    slot: int
    writes: bool

    @property
    def offset(self) -> int:
        return sum(self.sizes[:self.slot])


def col_layout(n: int, replicated: bool = False, device=None) -> ColLayout | None:
    """The layout of a gather of this process's n columns: None (every
    process n, `gather_cols` in rank order) unless a row split is in force.
    Under the split each process's columns are its own (pixels of its rows:
    one slot a process, the widths exchanged in one small all-reduce), or,
    with `replicated`, the same on every rank of its model group (one slot a
    data group, written by its model rank 0)."""
    split = _ACTIVE.get()
    if split is None:
        return None
    mesh = split.mesh
    if replicated:
        return ColLayout((n,) * mesh.data, mesh.data_index, mesh.model_index == 0)
    rank, size = world()
    sizes = torch.zeros(size, dtype=torch.float64, device=device)
    sizes[rank] = n
    dist.all_reduce(sizes)
    return ColLayout(tuple(int(v) for v in sizes.tolist()), rank, True)


@torch.no_grad()
def gather_cols(t: torch.Tensor, layout: ColLayout | None = None) -> torch.Tensor:
    """[R, P] per process → [R, W·P], the processes' columns side by side in
    rank order (no gradient); with a `col_layout` the slots' columns side by
    side, through one all-reduce (gloo takes only all-reduce and broadcast
    on CUDA tensors)."""
    if not data_parallel():
        return t
    if layout is None:
        parts = [torch.empty_like(t) for _ in range(world()[1])]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=1)
    buf = t.new_zeros((t.shape[0], sum(layout.sizes)), dtype=comm_dtype(t.dtype))
    if layout.writes:
        buf[:, layout.offset:layout.offset + t.shape[1]] = t
    dist.all_reduce(buf)
    return buf.to(t.dtype)


def own_cols(t: torch.Tensor, n: int, layout: ColLayout | None = None) -> torch.Tensor:
    """This process's n columns of a `gather_cols` result."""
    r = world()[0] * n if layout is None else layout.offset
    return t[:, r:r + n]


def rand_rows(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """torch.rand(shape) of this process's rows: every process draws the
    [D·shape[0], ...] uniforms that one process would draw for the global
    batch and keeps rows [d·shape[0], (d+1)·shape[0]), d its data index of
    D (its rank of W with no row split in force: `mesh.data_world`). The
    generators stay in step, since each draws the same count."""
    rank, size = data_world()
    if size == 1:
        return torch.rand(shape, generator=generator, device=device)
    b = shape[0]
    u = torch.rand((size * b, *shape[1:]), generator=generator, device=device)
    return u[rank * b:(rank + 1) * b]


@torch.no_grad()
def average_gradients(params) -> None:
    """Replace each parameter's gradient by its mean over the processes, in
    one all-reduce of the flattened gradients."""
    if not data_parallel():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    flat /= world()[1]
    for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(avg)


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Give every process rank 0's parameters and buffers."""
    if not data_parallel():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, 0)


def barrier() -> None:
    if data_parallel():
        dist.barrier()
