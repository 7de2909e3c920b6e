"""Shared NN building blocks (counterpart of `pmf_tpu/models/layers.py`,
eval semantics).

Parameters stay float32 whatever the compute dtype; a conv casts its weights
to the dtype of its input, and eval-mode BatchNorm computes its coefficients
in float32 before applying them in that dtype, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.01) as max(x, 0.01x)."""
    return torch.maximum(x, x * 0.01)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (torch integer padding) that runs in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with torch's hyperparameters (eps 1e-5, momentum 0.1).
    At eval it is y = x·a + b with a = γ/√(σ²+ε), b = β − μ·a."""

    def fold(self):
        """The eval coefficients (a, b), float32."""
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        return a, self.bias - self.running_mean * a

    def forward(self, x):
        if self.training:
            return super().forward(x)
        a, b = self.fold()
        return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def conv_bn(x, conv: nn.Conv2d, bn: BatchNorm2d, act=None):
    """conv → BN [→ act], with the BN folded into the conv at eval:
    BN(conv_k(x) + c) == conv_{k·a}(x) + (c·a + b)."""
    if bn.training:
        y = bn(conv(x))
    else:
        a, b = bn.fold()
        w = conv.weight * a[:, None, None, None]
        bias = b if conv.bias is None else conv.bias * a + b
        y = conv._conv_forward(x, w.to(x.dtype), bias.to(x.dtype))
    return y if act is None else act(y)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride 2, padding 1, count_include_pad=True)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, stride 2, padding 1), the ResNet stem pool."""
    return F.max_pool2d(x, 3, stride=2, padding=1)
