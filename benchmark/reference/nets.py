"""PMFNet and EPMFNet with the ResNet34 camera encoder, in plain PyTorch.

Module names are the port's (and the original pc_processor's), so one
state_dict loads into both. Everything computes in float32; BN takes the
batch's statistics in train mode (biased variance, the running statistics
moving by 0.1) and its running ones at eval, applied unfolded; channel
dropout draws from the generator that `forward` takes, in the same order as
the port. With `set_fp8(model)` every convolution's input, weight and
output and every BN's output are rounded to float8 e4m3 (each tensor
scaled by its largest magnitude), and the gradients flowing back through
them to e5m2: the activations held in float8 where the port holds them in
bfloat16. That is the control, the same nets one precision below the
configurations' bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _round(t: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """t rounded to the float8 `dtype` under a per-tensor scale (its largest
    magnitude to the format's largest), back in t's dtype."""
    scale = t.abs().amax().clamp(min=1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Float8(torch.autograd.Function):
    """Rounds a tensor to float8 e4m3, and the gradient that flows back
    through it to float8 e5m2: the usual float8 training recipe."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


to_fp8 = _Float8.apply


def leaky_relu(x):
    return torch.maximum(x, x * 0.01)


class Conv2d(nn.Conv2d):
    fp8 = False

    def reset_parameters(self):
        pass        # the weights are always loaded

    def forward(self, x):
        if not self.fp8:
            return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                            self.groups)
        y = F.conv2d(to_fp8(x), to_fp8(self.weight), self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return to_fp8(y)


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (Conv2d, BatchNorm2d)):
            m.fp8 = on
    return model


class BatchNorm2d(nn.BatchNorm2d):
    fp8 = False

    def forward(self, x):
        y = self._bn(x)
        return to_fp8(y) if self.fp8 else y

    def _bn(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = torch.rsqrt(var + self.eps) * self.weight
        return x * a[:, None, None] + (self.bias - mean * a)[:, None, None]


class Dropout2d(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, g=None):
        if not self.training or self.p == 0:
            return x
        keep = torch.rand(x.shape[:2] + (1, 1), generator=g, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def upsample(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu(x)


class PixelShuffle(nn.Module):
    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        return F.pixel_shuffle(x, self.r)


# --- the ResNet34 camera encoder (stem stride 1; dropout after layer3, layer4)

class BasicBlock(nn.Module):
    def __init__(self, cin, width, stride, downsample):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.downsample = nn.Sequential(Conv2d(cin, width, 1, stride=stride, bias=False),
                                        BatchNorm2d(width)) if downsample else None

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet34(nn.Module):
    feature_channels = (64, 128, 256, 512)

    def __init__(self, dropout_rate: float = 0.2):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            blocks = []
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(BasicBlock(cin, width, stride, i == 0 and (stride != 1 or cin != width)))
                cin = width
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.dropout = Dropout2d(dropout_rate)

    def forward(self, x, g=None):
        out = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            out = layer(out)
            feats.append(out)
        feats[2] = self.dropout(feats[2], g)
        feats[3] = self.dropout(feats[3], g)
        return feats


# --- SalsaNext's blocks (conv → LeakyReLU → BN)

class ResContextBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 1)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x):
        shortcut = leaky_relu(self.conv1(x))
        res = self.bn1(leaky_relu(self.conv2(shortcut)))
        return shortcut + self.bn2(leaky_relu(self.conv3(res)))


class ResBlock(nn.Module):
    def __init__(self, cin, cout, p=0.2, pooling=True, drop_out=True):
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
        self.dropout = Dropout2d(p if drop_out else 0.0)

    def forward(self, x, g=None):
        shortcut = leaky_relu(self.conv1(x))
        a1 = self.bn1(leaky_relu(self.conv2(x)))
        a2 = self.bn2(leaky_relu(self.conv3(a1)))
        a3 = self.bn3(leaky_relu(self.conv4(a2)))
        res = shortcut + self.bn4(leaky_relu(self.conv5(torch.cat([a1, a2, a3], 1))))
        out = self.dropout(res, g)
        if self.pooling:
            return F.avg_pool2d(out, 3, stride=2, padding=1, count_include_pad=True), res
        return out


class UpBlock(nn.Module):
    def __init__(self, cin, cskip, cout, p=0.2, drop_out=True):
        super().__init__()
        p = p if drop_out else 0.0
        self.dropout1, self.dropout2, self.dropout3 = Dropout2d(p), Dropout2d(p), Dropout2d(p)
        self.conv1 = Conv2d(cin // 4 + cskip, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 2, padding=1, dilation=2)
        self.bn3 = BatchNorm2d(cout)
        self.conv4 = Conv2d(3 * cout, cout, 1)
        self.bn4 = BatchNorm2d(cout)

    def forward(self, x, skip, g=None):
        up = self.dropout1(F.pixel_shuffle(x, 2), g)
        up = self.dropout2(torch.cat([up, skip], 1), g)
        e1 = self.bn1(leaky_relu(self.conv1(up)))
        e2 = self.bn2(leaky_relu(self.conv2(e1)))
        e3 = self.bn3(leaky_relu(self.conv3(e2)))
        e = self.bn4(leaky_relu(self.conv4(torch.cat([e1, e2, e3], 1))))
        return self.dropout3(e, g)


# --- the fusion pieces

class FusionBlock(nn.Module):
    """fused = BN(lrelu(conv(cat))), out = fused·σ(att(fused)) + pcd."""

    def __init__(self, c, img_c):
        super().__init__()
        self.fuse_conv = nn.Sequential(Conv2d(c + img_c, c, 3, padding=1), LeakyReLU(),
                                       BatchNorm2d(c))
        self.attention = nn.Sequential(Conv2d(c, c, 3, padding=1), BatchNorm2d(c), nn.ReLU(),
                                       Conv2d(c, c, 3, padding=1), BatchNorm2d(c), nn.Sigmoid())

    def forward(self, pcd, img):
        fused = self.fuse_conv(torch.cat([pcd, img], 1))
        return fused * self.attention(fused) + pcd


class ASPP(nn.Module):
    def __init__(self, cin, depth):
        super().__init__()
        self.conv = Conv2d(cin, depth, 1)
        self.atrous_block1 = Conv2d(cin, depth, 1)
        self.atrous_block6 = Conv2d(cin, depth, 3, padding=6, dilation=6)
        self.atrous_block12 = Conv2d(cin, depth, 3, padding=12, dilation=12)
        self.atrous_block18 = Conv2d(cin, depth, 3, padding=18, dilation=18)
        self.conv_1x1_output = Conv2d(depth * 5, depth, 1)

    def forward(self, x):
        gp = self.conv(x.mean(dim=(2, 3), keepdim=True)).expand(-1, -1, *x.shape[2:])
        return self.conv_1x1_output(torch.cat([gp, self.atrous_block1(x), self.atrous_block6(x),
                                               self.atrous_block12(x), self.atrous_block18(x)], 1))


class LidarStream(nn.Module):
    """PMF's SalsaNext with a fusion block after resBlocks 1-4 and ASPP."""

    def __init__(self, img_c, nclasses, bc, p=0.2):
        super().__init__()
        self.downCntx = ResContextBlock(5, bc)
        self.downCntx2 = ResContextBlock(bc, bc)
        self.downCntx3 = ResContextBlock(bc, bc)
        self.resBlock1 = ResBlock(bc, 2 * bc, p, drop_out=False)
        self.fusionblock_1 = FusionBlock(2 * bc, img_c[0])
        self.resBlock2 = ResBlock(2 * bc, 4 * bc, p)
        self.fusionblock_2 = FusionBlock(4 * bc, img_c[1])
        self.resBlock3 = ResBlock(4 * bc, 8 * bc, p)
        self.fusionblock_3 = FusionBlock(8 * bc, img_c[2])
        self.resBlock4 = ResBlock(8 * bc, 8 * bc, p)
        self.fusionblock_4 = FusionBlock(8 * bc, img_c[3])
        self.resBlock5 = ResBlock(8 * bc, 8 * bc, p, pooling=False)
        self.aspp = ASPP(8 * bc, 8 * bc)
        self.upBlock1 = UpBlock(8 * bc, 8 * bc, 4 * bc, p)
        self.upBlock2 = UpBlock(4 * bc, 8 * bc, 4 * bc, p)
        self.upBlock3 = UpBlock(4 * bc, 4 * bc, 2 * bc, p)
        self.upBlock4 = UpBlock(2 * bc, 2 * bc, bc, p, drop_out=False)
        self.logits = Conv2d(bc, nclasses, 1)

    def forward(self, x, img, g=None):
        c = self.downCntx3(self.downCntx2(self.downCntx(x)))
        skips = []
        for i in range(1, 5):
            c, skip = getattr(self, f"resBlock{i}")(c, g)
            c = getattr(self, f"fusionblock_{i}")(c, img[i - 1])
            skips.append(skip)
        up = self.aspp(self.resBlock5(c, g))
        for block, skip in zip((self.upBlock1, self.upBlock2, self.upBlock3, self.upBlock4),
                               reversed(skips)):
            up = block(up, skip, g)
        return torch.softmax(self.logits(up), dim=1)


class RGBDecoder(nn.Module):
    def __init__(self, in_c, nclasses, bc=16):
        super().__init__()

        def stage(cin, k, pad):
            return nn.Sequential(Conv2d(cin, bc, k, padding=pad), LeakyReLU(), BatchNorm2d(bc))

        self.up_4a = stage(in_c[3], 3, 1)
        self.up_3a = stage(bc + in_c[2], 3, 1)
        self.up_2a = stage(bc + in_c[1], 3, 1)
        self.up_1a = stage(bc + in_c[0], 1, 0)
        self.conv = Conv2d(bc, nclasses, 3, padding=1)

    def forward(self, feats):
        up = upsample(self.up_4a(feats[3]))
        for block, skip in ((self.up_3a, feats[2]), (self.up_2a, feats[1]),
                            (self.up_1a, feats[0])):
            up = upsample(block(torch.cat([up, skip], 1)))
        return torch.softmax(self.conv(up), dim=1)


class PMFNet(nn.Module):
    """forward(pcd [B, H, W, 5], img [B, H, W, 3], g) → (lidar, camera)
    class probabilities [B, H, W, C]."""

    def __init__(self, nclasses=20, base_channels=32, dropout_rate=0.2):
        super().__init__()
        self.camera_stream_encoder = ResNet34(dropout_rate)
        chans = ResNet34.feature_channels
        self.camera_stream_decoder = RGBDecoder(chans, nclasses, 16)
        self.lidar_stream = LidarStream(chans, nclasses, base_channels, dropout_rate)

    def forward(self, pcd, img, g=None):
        pcd, img = pcd.permute(0, 3, 1, 2).float(), img.permute(0, 3, 1, 2).float()
        feats = self.camera_stream_encoder(img, g)
        lidar = self.lidar_stream(pcd, feats, g)
        camera = self.camera_stream_decoder(feats)
        return lidar.permute(0, 2, 3, 1), camera.permute(0, 2, 3, 1)


# --- EPMF's pieces (sparse context blocks at half resolution, head back up)

class SparseConv(nn.Module):
    """(conv(x·mask) + bias) · mask', mask' = the mask after the conv's window."""

    def __init__(self, cin, cout, k=3, padding=1, stride=1, dilation=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=padding, dilation=dilation)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, mask):
        c = self.conv
        with torch.no_grad():
            new = F.max_pool2d(F.pad(mask, (c.padding[0],) * 4), c.kernel_size[0],
                               stride=c.stride[0], dilation=c.dilation[0])
        return (c(x * mask) + self.bias[:, None, None]) * new, new


class SparseContextBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = SparseConv(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = SparseConv(cout, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv3 = SparseConv(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x):
        mask = (x != 0).any(dim=1, keepdim=True).float()
        shortcut, mask = self.conv1(x, mask)
        shortcut = leaky_relu(shortcut)
        res, mask = self.conv2(shortcut, mask)
        res1 = self.bn1(leaky_relu(res))
        res, mask = self.conv3(res1, mask)
        return (shortcut + self.bn2(leaky_relu(res))) * mask


def extra_upsample(cin, cout):
    return nn.Sequential(Conv2d(cin, cout, 3, padding=1), LeakyReLU(), BatchNorm2d(cout),
                         PixelShuffle(2))


class LidarStreamV2(nn.Module):
    def __init__(self, img_c, nclasses, bc, p=0.2):
        super().__init__()
        self.downCntx = SparseContextBlock(5, bc)
        self.downCntx2 = SparseContextBlock(bc, bc)
        self.downCntx3 = SparseContextBlock(bc, bc, stride=2)
        self.fusionblock_1 = FusionBlock(bc, img_c[0])
        self.resBlock1 = ResBlock(bc, 2 * bc, p, drop_out=False)
        self.fusionblock_2 = FusionBlock(2 * bc, img_c[1])
        self.resBlock2 = ResBlock(2 * bc, 4 * bc, p)
        self.fusionblock_3 = FusionBlock(4 * bc, img_c[2])
        self.resBlock3 = ResBlock(4 * bc, 8 * bc, p)
        self.fusionblock_4 = FusionBlock(8 * bc, img_c[3])
        self.resBlock4 = ResBlock(8 * bc, 8 * bc, p)
        self.resBlock5 = ResBlock(8 * bc, 8 * bc, p, pooling=False)
        self.aspp = ASPP(8 * bc, 8 * bc)
        self.upBlock1 = UpBlock(8 * bc, 8 * bc, 4 * bc, p)
        self.upBlock2 = UpBlock(4 * bc, 8 * bc, 4 * bc, p)
        self.upBlock3 = UpBlock(4 * bc, 4 * bc, 2 * bc, p)
        self.upBlock4 = UpBlock(2 * bc, 2 * bc, bc, p, drop_out=False)
        self.extraUpSample = extra_upsample(bc, 4 * bc)
        self.logits = Conv2d(bc, nclasses, 1)

    def forward(self, x, img, g=None):
        c = self.downCntx3(self.downCntx2(self.downCntx(x)))
        skips = []
        for i in range(1, 5):
            c = getattr(self, f"fusionblock_{i}")(c, img[i - 1])
            c, skip = getattr(self, f"resBlock{i}")(c, g)
            skips.append(skip)
        bottleneck = self.aspp(self.resBlock5(c, g))
        up = bottleneck
        for block, skip in zip((self.upBlock1, self.upBlock2, self.upBlock3, self.upBlock4),
                               reversed(skips)):
            up = block(up, skip, g)
        return torch.softmax(self.logits(self.extraUpSample(up)), dim=1), bottleneck


class RGBDecoderV2(RGBDecoder):
    def __init__(self, in_c, nclasses, bc=16, lidar_bc=32):
        super().__init__([*in_c[:3], 2 * lidar_bc + in_c[3]], nclasses, bc)
        self.extraUpSample = extra_upsample(8 * lidar_bc, 8 * lidar_bc)
        self.aspp = ASPP(in_c[3], in_c[3])

    def forward(self, feats, lidar_feature):
        fuse = torch.cat([self.extraUpSample(lidar_feature), self.aspp(feats[3])], 1)
        return super().forward([*feats[:3], fuse])


class EPMFNet(nn.Module):
    def __init__(self, nclasses=20, base_channels=32, dropout_rate=0.2):
        super().__init__()
        self.camera_stream_encoder = ResNet34(dropout_rate)
        chans = ResNet34.feature_channels
        self.camera_stream_decoder = RGBDecoderV2(chans, nclasses, 16, base_channels)
        self.lidar_stream = LidarStreamV2(chans, nclasses, base_channels, dropout_rate)

    def forward(self, pcd, img, g=None):
        pcd, img = pcd.permute(0, 3, 1, 2).float(), img.permute(0, 3, 1, 2).float()
        feats = self.camera_stream_encoder(img, g)
        lidar, bottleneck = self.lidar_stream(pcd, feats, g)
        camera = self.camera_stream_decoder(feats, bottleneck)
        return lidar.permute(0, 2, 3, 1), camera.permute(0, 2, 3, 1)


NETS = {"PMFNet": PMFNet, "EPMFNet": EPMFNet}
