"""Shared NN building blocks (counterpart of `pmf_tpu/models/layers.py`).

Parameters stay float32 whatever the compute dtype; a conv casts its weights
to the dtype of its input, and BatchNorm computes its coefficients in float32
before applying them in that dtype, as the JAX package does.

`remat_stage` is the nets' rematerialization (pmf_tpu's `remat`, which
wraps the train-mode forward in `jax.checkpoint`): a stage's activations are
computed again in the backward pass instead of being kept.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import epilogue, epilogue_train
from ..parallel import data_parallel, global_sum_count, rand_rows, spatial

# True while `remat_stage` recomputes a stage in the backward pass: the
# stage's BN layers took this batch's statistics into their running ones in
# the forward
_RECOMPUTING: ContextVar = ContextVar("pmf_tpu_torch_recomputing", default=False)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.01) as max(x, 0.01x). Its subgradient at x == 0 is 0.505
    (torch.maximum splits a tie's gradient in halves), the same as the JAX
    package's; F.leaky_relu would give 1."""
    return torch.maximum(x, x * 0.01)


LECUN_TRUNC = 0.87962566103423978  # the std of a unit normal truncated at ±2


class Conv2d(nn.Conv2d):
    """nn.Conv2d (torch integer padding) that runs in its input's dtype,
    initialized as pmf_tpu's flax convs are: the kernel from `lecun_normal`
    (a normal truncated at ±2 of its std, std = sqrt(1/fan_in) / 0.8796...,
    fan_in = kh·kw·cin, so its variance is 1/fan_in), the bias zeros. The
    draw comes from torch's global generator (`torch.manual_seed`)."""

    @torch.no_grad()
    def reset_parameters(self):
        fan_in = self.weight[0].numel()
        w = self.weight.view(-1).normal_()
        # truncate at ±2 by drawing the values past it again (torch's
        # trunc_normal_ redraws the whole tensor until none is left: 20x slower)
        redo = (w.abs() > 2.0).nonzero().squeeze(1)
        while redo.numel():
            w[redo] = torch.randn(redo.numel(), dtype=w.dtype, device=w.device)
            redo = redo[w[redo].abs() > 2.0]
        w.mul_((1.0 / fan_in) ** 0.5 / LECUN_TRUNC)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def _conv_forward(self, x, weight, bias):
        """The convolution; while a row split is in force, this rank's output
        rows from the input rows they read (`parallel.spatial`). A conv that
        maps each row to itself (1×1, stride 1, no row padding) needs no
        other rows, and takes replicated inputs too (ASPP's pooled branch)."""
        if spatial.active() is None:
            return super()._conv_forward(x, weight, bias)
        (k, _), (s, _), (d, _), (p, pw) = (self.kernel_size, self.stride, self.dilation,
                                           self.padding)
        if k == s == 1 and p == 0 and x.shape[2] > 0:
            return super()._conv_forward(x, weight, bias)
        conv = lambda block: F.conv2d(block, weight, bias, self.stride, (0, pw), self.dilation,
                                      self.groups)
        return spatial.window_op(x, k, s, d, p, conv)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with torch's hyperparameters (eps 1e-5, momentum 0.1),
    applied as y = x·a + b in the input's dtype with a = γ/√(σ²+ε) and
    b = β − μ·a computed in float32.

    At eval μ and σ² are the running statistics. In train mode they are the
    batch's, in float32 (float64 for a float64 input) from the input as it
    is: μ = E[x] and the biased σ² = E[x²] − E[x]², with the gradient
    flowing through both, and the running statistics move by 0.1 towards
    them (pmf_tpu's _DenseBatchNorm; nn.BatchNorm2d would update the running
    variance with the unbiased one). While a process group is up the batch
    is the global one: the per-channel [Σx, Σx²] are summed over the
    processes (`parallel.global_sum_count`, the gradient flowing back
    through the sum; under a row split the element counts too, since the
    blocks can be uneven), as pmf_tpu's BN over a sharded batch takes them
    (nn.SyncBatchNorm would again move the running variance towards the
    unbiased estimate)."""

    def fold(self):
        """The eval coefficients (a, b), float32."""
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        return a, self.bias - self.running_mean * a

    def forward(self, x, dtype: torch.dtype | None = None):
        """BN(x), applied in `dtype` (x's own by default) after the
        statistics are taken from x as it is."""
        if not self.training:
            a, b = self.fold()
        else:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            dims = (0, 2, 3)
            sums, n = global_sum_count(torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]),
                                       xf.numel() // xf.shape[1])
            mean = sums[0] / n
            var = sums[1] / n - mean * mean
            if not _RECOMPUTING.get():
                with torch.no_grad():
                    m = 1.0 - self.momentum
                    self.running_mean.copy_(m * self.running_mean + self.momentum * mean)
                    self.running_var.copy_(m * self.running_var + self.momentum * var)
            a = torch.rsqrt(var + self.eps) * self.weight
            b = self.bias - mean * a
        x = x if dtype is None else x.to(dtype)
        return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


class Dropout2d(nn.Module):
    """Channel dropout (torch's Dropout2d, pmf_tpu's Dropout2d): in train
    mode each (sample, channel) plane is zeroed with probability p and the
    rest scaled by 1/(1−p). The mask comes from the `generator` the caller
    passes, never from the global RNG (this process's rows of the global
    batch's mask while a process group is up, the same on every rank of a
    model group: `parallel.rand_rows`); a
    train-mode call with p > 0 and no generator raises. p = 0 is the
    identity."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.p == 0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator")
        keep = rand_rows(x.shape[:2] + (1, 1), generator, x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


_ACTS = {None: lambda x: x, "relu": torch.relu, "leaky_relu": leaky_relu,
         "sigmoid": torch.sigmoid}


def _kernels_take(x: torch.Tensor, residual) -> bool:
    """Whether the epilogue kernels take a conv on x: x (and residual) CUDA
    bf16 contiguous in channels_last, outside a row split."""
    return (spatial.active() is None and epilogue.epilogue_takes(x)
            and (residual is None or epilogue.epilogue_takes(residual)))


def _fuses(x: torch.Tensor, residual, bn) -> bool:
    """Whether a conv on x runs without its bias and leaves the rest to one
    `epilogue.conv_epilogue` pass: in inference (grad off, BN in eval mode)
    where `_kernels_take`."""
    return (not torch.is_grad_enabled() and (bn is None or not bn.training)
            and _kernels_take(x, residual))


def _fuses_train(x: torch.Tensor, residual, bn, family: str, act, post) -> bool:
    """Whether a train-mode conv on x runs without its bias and leaves the
    batch-statistics BN, act, the residual and post to
    `epilogue_train.bn_epilogue` (two passes forward, two backward): grad
    on, BN in train mode, where `_kernels_take`, a variant and width the
    kernels hold, and no process group (the BN sums would cross
    processes)."""
    return (torch.is_grad_enabled() and bn.training and not data_parallel()
            and _kernels_take(x, residual)
            and epilogue_train.takes(bn.num_features, family, act, residual is not None, post))


def _bn_train_epilogue(y, bias, bn: BatchNorm2d, family: str, act, residual, post):
    """`epilogue_train.bn_epilogue` with bn's parameters, moving its running
    statistics unless a remat stage is being recomputed."""
    running = None if _RECOMPUTING.get() else (bn.running_mean, bn.running_var)
    return epilogue_train.bn_epilogue(y, bias, bn.weight, bn.bias, family, act, residual, post,
                                      running, bn.eps, bn.momentum)


def _chain(y, act, bn=None, residual=None, post=None):
    """The epilogue as PyTorch's ops: act, BN, + residual, post."""
    y = _ACTS[act](y)
    if bn is not None:
        y = bn(y)
    if residual is not None:
        y = y + residual
    return _ACTS[post](y)


def _conv_then_epilogue(x, conv: Conv2d, w, bias, act, bn, residual, post):
    """post(BN(act(conv_w(x) + bias)) + residual) with `conv`'s geometry, its
    kernel w and the bias given. Where `_fuses` holds the conv runs without
    its bias and one pass of `epilogue.conv_epilogue` does the rest, where
    `_fuses_train` holds `epilogue_train.bn_epilogue`'s passes; else
    PyTorch's ops, as the modules run them."""
    if bn is not None and _fuses_train(x, residual, bn, "act_bn", act, post):
        y = conv._conv_forward(x, w.to(x.dtype), None)
        return _bn_train_epilogue(y, bias, bn, "act_bn", act, residual, post)
    if _fuses(x, residual, bn):
        y = conv._conv_forward(x, w.to(x.dtype), None)
        a, b = (None, None) if bn is None else bn.fold()
        return epilogue.conv_epilogue(y, bias.float(), act, a, b, residual, post)
    return _chain(conv._conv_forward(x, w.to(x.dtype), bias.to(x.dtype)), act, bn, residual,
                  post)


def conv_block(x, conv: Conv2d, act: str | None = None, bn: BatchNorm2d | None = None,
               residual=None, post: str | None = None):
    """post(BN(act(conv(x))) + residual): `act` and `post` are None, "relu",
    "leaky_relu" or "sigmoid"; `bn`, the residual and `post` optional; one
    pass of the epilogue kernel where `_fuses` holds (`_conv_then_epilogue`)."""
    return _conv_then_epilogue(x, conv, conv.weight, conv.bias, act, bn, residual, post)


def conv_bn(x, conv: nn.Conv2d, bn: BatchNorm2d, act: str | None = None, residual=None,
            post: str | None = None):
    """post(act(BN(conv(x))) + residual) (`conv_block`'s names), with the BN
    folded into the conv at eval: BN(conv_k(x) + c) == conv_{k·a}(x) +
    (c·a + b), then `_conv_then_epilogue`. In train mode the batch
    statistics need the conv's output, so BN runs unfolded after it: where
    `_fuses_train` holds, the conv without its bias and
    `epilogue_train.bn_epilogue`'s passes; else PyTorch's chain."""
    if bn.training:
        if _fuses_train(x, residual, bn, "bn_act", act, post):
            y = conv._conv_forward(x, conv.weight.to(x.dtype), None)
            return _bn_train_epilogue(y, conv.bias, bn, "bn_act", act, residual, post)
        return _chain(bn(conv(x)), act, None, residual, post)
    a, b = bn.fold()
    bias = b if conv.bias is None else conv.bias * a + b
    return _conv_then_epilogue(x, conv, conv.weight * a[:, None, None, None], bias, act, None,
                               residual, post)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride 2, padding 1, count_include_pad=True); under a row
    split the padding rows are zeros fetched with the window."""
    if spatial.active() is None:
        return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
    return spatial.window_op(x, 3, 2, 1, 1, lambda block: F.avg_pool2d(
        block, 3, stride=2, padding=(0, 1), count_include_pad=True))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, stride 2, padding 1), the ResNet stem pool; under a row
    split the padding rows are -inf, which no window picks."""
    if spatial.active() is None:
        return F.max_pool2d(x, 3, stride=2, padding=1)
    return spatial.window_op(x, 3, 2, 1, 1, lambda block: F.max_pool2d(
        block, 3, stride=2, padding=(0, 1)), fill=float("-inf"))


class _Recompute:
    """The context of a stage's recomputation, set up at its forward: the
    draws' generator at the state it had before the forward (and back at the
    state it stands at after), the row split that was in force (the backward
    pass may run on another thread, which does not see the caller's
    context), and BN's running statistics left alone."""

    def __init__(self, generator: torch.Generator | None):
        self.generator, self.split = generator, spatial.active()
        self.state = None if generator is None else generator.get_state()
        self._undo: list = []

    def __enter__(self):
        now = None if self.generator is None else self.generator.get_state()
        if now is not None:
            self.generator.set_state(self.state)
        split = contextlib.nullcontext() if self.split is None else self.split
        split.__enter__()
        self._undo.append((now, split, _RECOMPUTING.set(True)))

    def __exit__(self, *exc):
        now, split, mark = self._undo.pop()
        _RECOMPUTING.reset(mark)
        split.__exit__(*exc)
        if now is not None:
            self.generator.set_state(now)


def remat_stage(remat: bool, fn, *args, generator: torch.Generator | None = None):
    """fn(*args). With `remat`, while gradients are on, fn's activations are
    not kept for the backward pass, which runs fn again on the same args
    (torch.utils.checkpoint), and the same numbers come out: `generator`, the
    one fn's dropout draws from, replays its draws (checkpoint restores only
    the default generators, which the nets do not draw from), BN does not
    move its running statistics a second time, and the row split in force
    at the forward is in force again."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _Recompute(generator)))
