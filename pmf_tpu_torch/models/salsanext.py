"""SalsaNext range-image encoder-decoder (counterpart of
`pmf_tpu/models/salsanext.py`), on NCHW tensors.

The blocks apply conv → LeakyReLU → BatchNorm, in that order (the reference
puts the activation before the norm), so these BNs do not fold into a conv.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import pixel_shuffle
from .layers import BatchNorm2d, Conv2d, avg_pool_3x3_s2, leaky_relu


class ResContextBlock(nn.Module):
    """1×1 shortcut + (3×3 → 3×3 dilation 2) residual context block."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 1)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x):
        shortcut = leaky_relu(self.conv1(x))
        resA = self.bn1(leaky_relu(self.conv2(shortcut)))
        return shortcut + self.bn2(leaky_relu(self.conv3(resA)))


class ResBlock(nn.Module):
    """Dilated multi-branch residual block; with pooling it returns
    (pooled, pre-pool skip), else the block output."""

    def __init__(self, cin: int, cout: int, dropout_rate: float = 0.2,
                 pooling: bool = True, drop_out: bool = True):
        super().__init__()
        self.pooling = pooling
        self.conv1 = Conv2d(cin, cout, 1)
        self.conv2 = Conv2d(cin, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm2d(cout)
        self.conv4 = Conv2d(cout, cout, 2, padding=1, dilation=2)
        self.bn3 = BatchNorm2d(cout)
        self.conv5 = Conv2d(3 * cout, cout, 1)
        self.bn4 = BatchNorm2d(cout)
        self.dropout = nn.Dropout2d(dropout_rate) if drop_out else nn.Identity()

    def forward(self, x):
        shortcut = leaky_relu(self.conv1(x))
        resA1 = self.bn1(leaky_relu(self.conv2(x)))
        resA2 = self.bn2(leaky_relu(self.conv3(resA1)))
        resA3 = self.bn3(leaky_relu(self.conv4(resA2)))
        resA = self.bn4(leaky_relu(self.conv5(torch.cat([resA1, resA2, resA3], 1))))
        resA = shortcut + resA
        resB = self.dropout(resA)
        if self.pooling:
            return avg_pool_3x3_s2(resB), resA
        return resB


class UpBlock(nn.Module):
    """PixelShuffle ×2 upsample + skip concat + dilated multi-branch merge."""

    def __init__(self, cin: int, cskip: int, cout: int,
                 dropout_rate: float = 0.2, drop_out: bool = True):
        super().__init__()
        drop = (lambda: nn.Dropout2d(dropout_rate)) if drop_out else nn.Identity
        self.dropout1, self.dropout2, self.dropout3 = drop(), drop(), drop()
        self.conv1 = Conv2d(cin // 4 + cskip, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 2, padding=1, dilation=2)
        self.bn3 = BatchNorm2d(cout)
        self.conv4 = Conv2d(3 * cout, cout, 1)
        self.bn4 = BatchNorm2d(cout)

    def forward(self, x, skip):
        upA = self.dropout1(pixel_shuffle(x, 2))
        upB = self.dropout2(torch.cat([upA, skip], 1))
        upE1 = self.bn1(leaky_relu(self.conv1(upB)))
        upE2 = self.bn2(leaky_relu(self.conv2(upE1)))
        upE3 = self.bn3(leaky_relu(self.conv3(upE2)))
        upE = self.bn4(leaky_relu(self.conv4(torch.cat([upE1, upE2, upE3], 1))))
        return self.dropout3(upE)


class SalsaNext(nn.Module):
    """LiDAR-only SalsaNext: forward(x [N, H, W, C_in]) → per-pixel class
    probabilities [N, H, W, nclasses] (or logits with softmax=False)."""

    def __init__(self, nclasses: int = 20, base_channels: int = 32,
                 in_channels: int = 5, softmax: bool = True,
                 dropout_rate: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        bc, p = base_channels, dropout_rate
        self.dtype, self.softmax = dtype, softmax
        self.downCntx = ResContextBlock(in_channels, bc)
        self.downCntx2 = ResContextBlock(bc, bc)
        self.downCntx3 = ResContextBlock(bc, bc)
        self.resBlock1 = ResBlock(bc, 2 * bc, p, drop_out=False)
        self.resBlock2 = ResBlock(2 * bc, 4 * bc, p)
        self.resBlock3 = ResBlock(4 * bc, 8 * bc, p)
        self.resBlock4 = ResBlock(8 * bc, 8 * bc, p)
        self.resBlock5 = ResBlock(8 * bc, 8 * bc, p, pooling=False)
        self.upBlock1 = UpBlock(8 * bc, 8 * bc, 4 * bc, p)
        self.upBlock2 = UpBlock(4 * bc, 8 * bc, 4 * bc, p)
        self.upBlock3 = UpBlock(4 * bc, 4 * bc, 2 * bc, p)
        self.upBlock4 = UpBlock(2 * bc, 2 * bc, bc, p, drop_out=False)
        self.logits = Conv2d(bc, nclasses, 1)

    def forward(self, x):
        c = x.permute(0, 3, 1, 2).to(self.dtype)
        c = self.downCntx3(self.downCntx2(self.downCntx(c)))
        down0c, down0b = self.resBlock1(c)
        down1c, down1b = self.resBlock2(down0c)
        down2c, down2b = self.resBlock3(down1c)
        down3c, down3b = self.resBlock4(down2c)
        down5c = self.resBlock5(down3c)
        up = self.upBlock1(down5c, down3b)
        up = self.upBlock2(up, down2b)
        up = self.upBlock3(up, down1b)
        up = self.upBlock4(up, down0b)
        logits = self.logits(up).float()
        out = torch.softmax(logits, dim=1) if self.softmax else logits
        return out.permute(0, 2, 3, 1)
