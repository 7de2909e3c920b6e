"""Shared NN building blocks (counterpart of `pmf_tpu/models/layers.py`).

Parameters stay float32 whatever the compute dtype; a conv casts its weights
to the dtype of its input, and BatchNorm computes its coefficients in float32
before applying them in that dtype, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import global_sum_count, rand_rows, spatial


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


def conv_bn(x, conv: nn.Conv2d, bn: BatchNorm2d, act=None):
    """conv → BN [→ act], with the BN folded into the conv at eval:
    BN(conv_k(x) + c) == conv_{k·a}(x) + (c·a + b). In train mode the
    batch statistics need the conv's output, so the chain runs unfolded."""
    if bn.training:
        y = bn(conv(x))
    else:
        a, b = bn.fold()
        w = conv.weight * a[:, None, None, None]
        bias = b if conv.bias is None else conv.bias * a + b
        y = conv._conv_forward(x, w.to(x.dtype), bias.to(x.dtype))
    return y if act is None else act(y)


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
