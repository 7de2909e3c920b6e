"""Two exported layers that no shipped net uses, kept for the reference's
API (counterpart of `pmf_tpu/models/modules.py`): `ConvUpSample` (bilinear
upsample, 3×3 conv, BN, ReLU) and `CSAttention` (a 3×3 conv gated by the
sigmoid of another). NCHW; the flax trees cross through
`models/convert.py` (conv, bn, att_conv)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import upsample_bilinear
from .layers import BatchNorm2d, Conv2d


class ConvUpSample(nn.Module):
    def __init__(self, in_channels: int, features: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = Conv2d(in_channels, features, 3, padding=1)
        self.bn = BatchNorm2d(features)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(upsample_bilinear(x, self.scale))))


class CSAttention(nn.Module):
    """Channel-spatial attention: feature conv × sigmoid(gate conv)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 3, padding=1)
        self.att_conv = Conv2d(in_channels, features, 3, padding=1)

    def forward(self, x):
        return self.conv(x) * torch.sigmoid(self.att_conv(x))
