"""ResNet camera encoder (counterpart of `pmf_tpu/models/resnet.py`).

torchvision's ResNet with the PMF changes: the 7×7 stem conv has stride 1
(only the max pool downsamples before layer1), and channel dropout follows
layer3 and layer4, its mask drawn from the generator that forward takes.
Module names are torchvision's (conv1, bn1, layer{s}.{i}.conv{j},
layer{s}.{i}.downsample.{0,1}), so torchvision and reference checkpoints
load as they are. Works on NCHW and returns the four stage outputs (strides
2, 4, 8, 16).
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from .layers import BatchNorm2d, Conv2d, Dropout2d, conv_bn, max_pool_3x3_s2

STAGES = {
    "resnet34": ([3, 4, 6, 3], "basic"),
    "resnet50": ([3, 4, 6, 3], "bottleneck"),
    "resnet101": ([3, 4, 23, 3], "bottleneck"),
    "resnet152": ([3, 8, 36, 3], "bottleneck"),
}


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False),
                         BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride) if downsample else None

    def forward(self, x):
        out = conv_bn(x, self.conv1, self.bn1, F.relu)
        out = conv_bn(out, self.conv2, self.bn2)
        if self.downsample is not None:
            x = conv_bn(x, *self.downsample)
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(width * 4)
        self.downsample = _downsample(cin, width * 4, stride) if downsample else None

    def forward(self, x):
        out = conv_bn(x, self.conv1, self.bn1, F.relu)
        out = conv_bn(out, self.conv2, self.bn2, F.relu)
        out = conv_bn(out, self.conv3, self.bn3)
        if self.downsample is not None:
            x = conv_bn(x, *self.downsample)
        return F.relu(out + x)


class ResNetEncoder(nn.Module):
    """4-stage feature extractor; forward(x [N, 3, H, W]) → [c1, c2, c3, c4]."""

    def __init__(self, backbone: str = "resnet34", dropout_rate: float = 0.2,
                 in_channels: int = 3):
        super().__init__()
        blocks, kind = STAGES[backbone]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.expansion = block.expansion
        self.feature_channels = [w * block.expansion for w in (64, 128, 256, 512)]
        self.conv1 = Conv2d(in_channels, 64, 7, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (n, width) in enumerate(zip(blocks, (64, 128, 256, 512))):
            layers = []
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                ds = i == 0 and (stride != 1 or cin != width * block.expansion)
                layers.append(block(cin, width, stride, ds))
                cin = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
        self.dropout = Dropout2d(dropout_rate)

    def forward(self, x, generator=None):
        if spatial.height(x) % 16 or x.shape[3] % 16:
            raise ValueError(f"invalid input size: {tuple(x.shape)}")
        out = max_pool_3x3_s2(conv_bn(x, self.conv1, self.bn1, F.relu))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            out = layer(out)
            feats.append(out)
        feats[2] = self.dropout(feats[2], generator)
        feats[3] = self.dropout(feats[3], generator)
        return feats
