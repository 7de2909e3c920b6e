"""PMFNet: two-stream perception-aware multi-sensor fusion network
(counterpart of `pmf_tpu/models/pmf.py`).

Module names follow the reference's pc_processor attribute names, nn.Sequential
indices included (fuse_conv.{0,2}, attention.{0,1,3,4}, up_{i}a.{0,2}), so a
reference checkpoint loads as it is and `pmf_tpu`'s converter maps this
model's state_dict onto the flax tree. Submodules work on NCHW; PMFNet takes
and returns channel-last tensors, as the JAX model does.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import upsample_bilinear
from ..parallel import spatial
from .layers import BatchNorm2d, Conv2d, conv_bn, leaky_relu
from .resnet import ResNetEncoder
from .salsanext import ResBlock, ResContextBlock, SalsaNext, UpBlock


class LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu(x)


class ResidualBasedFusionBlock(nn.Module):
    """Attention-gated residual fusion of camera features into the lidar
    stream: fused = BN(lrelu(conv(cat))), out = fused·σ(att(fused)) + pcd."""

    def __init__(self, pcd_channels: int, img_channels: int):
        super().__init__()
        c = pcd_channels
        self.fuse_conv = nn.Sequential(Conv2d(c + img_channels, c, 3, padding=1),
                                       LeakyReLU(), BatchNorm2d(c))
        self.attention = nn.Sequential(Conv2d(c, c, 3, padding=1), BatchNorm2d(c),
                                       nn.ReLU(), Conv2d(c, c, 3, padding=1),
                                       BatchNorm2d(c), nn.Sigmoid())

    def forward(self, pcd_feature, img_feature):
        # the convolutions run in the camera features' (compute) dtype; the
        # residual keeps pcd_feature's (EPMF's sparse stem gives float32)
        fused = self.fuse_conv(torch.cat([pcd_feature.to(img_feature.dtype), img_feature], 1))
        a = self.attention
        att = conv_bn(fused, a[0], a[1], torch.relu)
        att = torch.sigmoid(conv_bn(att, a[3], a[4]))
        return fused * att + pcd_feature


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: global-pool branch, 1×1, and 3×3
    dilated 6/12/18, merged by a 1×1 conv. Under a row split the global pool
    is the model group's (`spatial.spatial_mean`)."""

    def __init__(self, cin: int, depth: int):
        super().__init__()
        self.conv = Conv2d(cin, depth, 1)
        self.atrous_block1 = Conv2d(cin, depth, 1)
        self.atrous_block6 = Conv2d(cin, depth, 3, padding=6, dilation=6)
        self.atrous_block12 = Conv2d(cin, depth, 3, padding=12, dilation=12)
        self.atrous_block18 = Conv2d(cin, depth, 3, padding=18, dilation=18)
        self.conv_1x1_output = Conv2d(depth * 5, depth, 1)

    def forward(self, x):
        gp = self.conv(spatial.spatial_mean(x)).expand(-1, -1, *x.shape[2:])
        cat = torch.cat([gp, self.atrous_block1(x), self.atrous_block6(x),
                         self.atrous_block12(x), self.atrous_block18(x)], 1)
        return self.conv_1x1_output(cat)


class SalsaNextFusion(nn.Module):
    """SalsaNext lidar stream with a camera fusion block after each of
    resBlocks 1-4 and ASPP on the bottleneck. forward(x [N, 5, H, W],
    img_features) → lidar probabilities [N, nclasses, H, W]."""

    def __init__(self, img_channels, nclasses: int = 20, base_channels: int = 32,
                 in_channels: int = 5, dropout_rate: float = 0.2):
        super().__init__()
        bc, p = base_channels, dropout_rate
        self.downCntx = ResContextBlock(in_channels, bc)
        self.downCntx2 = ResContextBlock(bc, bc)
        self.downCntx3 = ResContextBlock(bc, bc)
        self.resBlock1 = ResBlock(bc, 2 * bc, p, drop_out=False)
        self.fusionblock_1 = ResidualBasedFusionBlock(2 * bc, img_channels[0])
        self.resBlock2 = ResBlock(2 * bc, 4 * bc, p)
        self.fusionblock_2 = ResidualBasedFusionBlock(4 * bc, img_channels[1])
        self.resBlock3 = ResBlock(4 * bc, 8 * bc, p)
        self.fusionblock_3 = ResidualBasedFusionBlock(8 * bc, img_channels[2])
        self.resBlock4 = ResBlock(8 * bc, 8 * bc, p)
        self.fusionblock_4 = ResidualBasedFusionBlock(8 * bc, img_channels[3])
        self.resBlock5 = ResBlock(8 * bc, 8 * bc, p, pooling=False)
        self.aspp = ASPP(8 * bc, 8 * bc)
        self.upBlock1 = UpBlock(8 * bc, 8 * bc, 4 * bc, p)
        self.upBlock2 = UpBlock(4 * bc, 8 * bc, 4 * bc, p)
        self.upBlock3 = UpBlock(4 * bc, 4 * bc, 2 * bc, p)
        self.upBlock4 = UpBlock(2 * bc, 2 * bc, bc, p, drop_out=False)
        self.logits = Conv2d(bc, nclasses, 1)

    def forward(self, x, img_features, generator=None):
        g = generator
        c = self.downCntx3(self.downCntx2(self.downCntx(x)))
        down0c, down0b = self.resBlock1(c, g)
        down0c = self.fusionblock_1(down0c, img_features[0])
        down1c, down1b = self.resBlock2(down0c, g)
        down1c = self.fusionblock_2(down1c, img_features[1])
        down2c, down2b = self.resBlock3(down1c, g)
        down2c = self.fusionblock_3(down2c, img_features[2])
        down3c, down3b = self.resBlock4(down2c, g)
        down3c = self.fusionblock_4(down3c, img_features[3])
        down5c = self.aspp(self.resBlock5(down3c, g))
        up = self.upBlock1(down5c, down3b, g)
        up = self.upBlock2(up, down2b, g)
        up = self.upBlock3(up, down1b, g)
        up = self.upBlock4(up, down0b, g)
        return torch.softmax(self.logits(up).float(), dim=1)


class RGBDecoder(nn.Module):
    """Camera-stream FCN decoder: four conv → LeakyReLU → BN → bilinear ×2
    stages with skip concats, then a 3×3 conv and softmax."""

    def __init__(self, in_channels, nclasses: int = 20, base_channels: int = 64):
        super().__init__()
        bc = base_channels

        def stage(cin, kernel, padding):
            return nn.Sequential(Conv2d(cin, bc, kernel, padding=padding),
                                 LeakyReLU(), BatchNorm2d(bc))

        self.up_4a = stage(in_channels[3], 3, 1)
        self.up_3a = stage(bc + in_channels[2], 3, 1)
        self.up_2a = stage(bc + in_channels[1], 3, 1)
        self.up_1a = stage(bc + in_channels[0], 1, 0)
        self.conv = Conv2d(bc, nclasses, 3, padding=1)

    def forward(self, inputs):
        up = upsample_bilinear(self.up_4a(inputs[3]))
        up = upsample_bilinear(self.up_3a(torch.cat([up, inputs[2]], 1)))
        up = upsample_bilinear(self.up_2a(torch.cat([up, inputs[1]], 1)))
        up = upsample_bilinear(self.up_1a(torch.cat([up, inputs[0]], 1)))
        return torch.softmax(self.conv(up).float(), dim=1)


class PMFNet(nn.Module):
    """Two-stream fusion net: forward(pcd [N, H, W, 5], img [N, H, W, 3]) →
    (lidar_probs, camera_probs), each [N, H, W, nclasses] float32.

    `dtype` is the compute dtype (float32 or bfloat16); parameters and BN
    statistics stay float32. In train mode the channel dropout draws its
    masks from `generator`, which forward then needs unless dropout_rate is
    0.
    """

    def __init__(self, nclasses: int = 20, base_channels: int = 32,
                 image_backbone: str = "resnet34", dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.camera_stream_encoder = ResNetEncoder(image_backbone, dropout_rate)
        chans = self.camera_stream_encoder.feature_channels
        self.camera_stream_decoder = RGBDecoder(
            chans, nclasses, base_channels=self.camera_stream_encoder.expansion * 16)
        self.lidar_stream = SalsaNextFusion(chans, nclasses, base_channels,
                                            dropout_rate=dropout_rate)

    def forward(self, pcd_feature, img_feature, generator=None):
        pcd = pcd_feature.permute(0, 3, 1, 2).to(self.dtype)
        img = img_feature.permute(0, 3, 1, 2).to(self.dtype)
        img_feats = self.camera_stream_encoder(img, generator)
        lidar = self.lidar_stream(pcd, img_feats, generator)
        camera = self.camera_stream_decoder(img_feats)
        return lidar.permute(0, 2, 3, 1), camera.permute(0, 2, 3, 1)


def build_model(opts) -> nn.Module:
    """The PMFNet, EPMFNet or SalsaNext (5 input channels) of an
    experiment's Options (net_type, nclasses, base_channels, img_backbone,
    compute_dtype), initialized as pmf_tpu's `model.init`: conv kernels
    from flax's `lecun_normal`, conv biases zeros (`layers.Conv2d`), BN
    scales 1 and biases 0, drawn from torch's global generator."""
    from .epmf import EPMFNet

    dtype = torch.bfloat16 if opts.compute_dtype == "bfloat16" else torch.float32
    if opts.net_type == "SalsaNext":
        return SalsaNext(nclasses=opts.nclasses, base_channels=opts.base_channels,
                         in_channels=5, dtype=dtype)
    nets = {"PMFNet": PMFNet, "EPMFNet": EPMFNet}
    if opts.net_type not in nets:
        raise NotImplementedError(f"{opts.net_type} is not ported yet")
    return nets[opts.net_type](nclasses=opts.nclasses, base_channels=opts.base_channels,
                               image_backbone=opts.img_backbone, dtype=dtype)
