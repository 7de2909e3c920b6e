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
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import world


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


@torch.no_grad()
def gather_cols(t: torch.Tensor) -> torch.Tensor:
    """[R, P] per process → [R, W·P], the processes' columns side by side in
    rank order (no gradient)."""
    if not data_parallel():
        return t
    parts = [torch.empty_like(t) for _ in range(world()[1])]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=1)


def own_cols(t: torch.Tensor, n: int) -> torch.Tensor:
    """This process's n columns of a `gather_cols` result."""
    r = world()[0]
    return t[:, r * n:(r + 1) * n]


def rand_rows(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """torch.rand(shape) of this process's rows: every process draws the
    [W·shape[0], ...] uniforms that one process would draw for the global
    batch and keeps rows [r·shape[0], (r+1)·shape[0]). The generators stay
    in step, since each draws the same count."""
    rank, size = world()
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
