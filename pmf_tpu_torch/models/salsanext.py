"""SalsaNext range-image encoder-decoder (counterpart of
`pmf_tpu/models/salsanext.py`), on NCHW tensors.

The blocks apply conv → LeakyReLU → BatchNorm, in that order (the reference
puts the activation before the norm), so these BNs do not fold into a conv;
in inference on the card each conv's bias, activation, BN and residual run
as one pass after it (`layers.conv_block`).
Channel dropout draws its masks from the generator that forward takes.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import pixel_shuffle
from ..utils.spans import span
from .layers import BatchNorm2d, Conv2d, Dropout2d, avg_pool_3x3_s2, conv_block


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
        shortcut = conv_block(x, self.conv1, "leaky_relu")
        resA = conv_block(shortcut, self.conv2, "leaky_relu", self.bn1)
        return conv_block(resA, self.conv3, "leaky_relu", self.bn2, residual=shortcut)


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
        self.dropout = Dropout2d(dropout_rate if drop_out else 0.0)

    def forward(self, x, generator=None):
        shortcut = conv_block(x, self.conv1, "leaky_relu")
        resA1 = conv_block(x, self.conv2, "leaky_relu", self.bn1)
        resA2 = conv_block(resA1, self.conv3, "leaky_relu", self.bn2)
        resA3 = conv_block(resA2, self.conv4, "leaky_relu", self.bn3)
        resA = conv_block(torch.cat([resA1, resA2, resA3], 1), self.conv5, "leaky_relu", self.bn4,
                          residual=shortcut)
        resB = self.dropout(resA, generator)
        if self.pooling:
            return avg_pool_3x3_s2(resB), resA
        return resB


class UpBlock(nn.Module):
    """PixelShuffle ×2 upsample + skip concat + dilated multi-branch merge."""

    def __init__(self, cin: int, cskip: int, cout: int,
                 dropout_rate: float = 0.2, drop_out: bool = True):
        super().__init__()
        p = dropout_rate if drop_out else 0.0
        self.dropout1, self.dropout2, self.dropout3 = Dropout2d(p), Dropout2d(p), Dropout2d(p)
        self.conv1 = Conv2d(cin // 4 + cskip, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 2, padding=1, dilation=2)
        self.bn3 = BatchNorm2d(cout)
        self.conv4 = Conv2d(3 * cout, cout, 1)
        self.bn4 = BatchNorm2d(cout)

    def forward(self, x, skip, generator=None):
        upA = self.dropout1(pixel_shuffle(x, 2), generator)
        upB = self.dropout2(torch.cat([upA, skip], 1), generator)
        upE1 = conv_block(upB, self.conv1, "leaky_relu", self.bn1)
        upE2 = conv_block(upE1, self.conv2, "leaky_relu", self.bn2)
        upE3 = conv_block(upE2, self.conv3, "leaky_relu", self.bn3)
        upE = conv_block(torch.cat([upE1, upE2, upE3], 1), self.conv4, "leaky_relu", self.bn4)
        return self.dropout3(upE, generator)


class SalsaNext(nn.Module):
    """LiDAR-only SalsaNext: forward(x [N, H, W, C_in]) → per-pixel class
    probabilities [N, H, W, nclasses] (or logits with softmax=False); a
    train-mode forward with dropout takes a torch.Generator."""

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

    def forward(self, x, generator=None):
        """The call is the span pmf.model holding pmf.model.lidar_stream
        (`utils/spans.py`), and that holds PMF's lidar-stream parts: .context
        (the three context blocks), .encoder (each of resBlock1-4), .head
        (resBlock5) and .decoder (the upBlocks and the logits)."""
        g = generator
        with span("pmf.model"), span("pmf.model.lidar_stream"):
            c = x.permute(0, 3, 1, 2).to(self.dtype)
            with span("pmf.model.lidar_stream.context"):
                c = self.downCntx3(self.downCntx2(self.downCntx(c)))
            skips = []
            for block in (self.resBlock1, self.resBlock2, self.resBlock3, self.resBlock4):
                with span("pmf.model.lidar_stream.encoder"):
                    c, skip = block(c, g)
                skips.append(skip)
            with span("pmf.model.lidar_stream.head"):
                up = self.resBlock5(c, g)
            with span("pmf.model.lidar_stream.decoder"):
                for block, skip in zip((self.upBlock1, self.upBlock2, self.upBlock3,
                                        self.upBlock4), reversed(skips)):
                    up = block(up, skip, g)
                logits = conv_block(up, self.logits).float()
                out = torch.softmax(logits, dim=1) if self.softmax else logits
                return out.permute(0, 2, 3, 1)
