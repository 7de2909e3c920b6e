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

from ..ops.aspp import aspp_branches, aspp_takes
from ..ops.resize import upsample_bilinear
from ..parallel import spatial
from ..utils.spans import span
from .graphs import GraphedNet
from .layers import BatchNorm2d, Conv2d, conv_block, conv_bn, leaky_relu, remat_stage
from .resnet import ResNetEncoder
from .salsanext import ResBlock, ResContextBlock, SalsaNext, UpBlock


class LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu(x)


class ConvStage(nn.Sequential):
    """conv → LeakyReLU → BN, then any further modules, under
    nn.Sequential's indices (a reference checkpoint's names); the first three
    run as one `conv_block`."""

    def forward(self, x):
        x = conv_block(x, self[0], "leaky_relu", self[2])
        for module in list(self)[3:]:
            x = module(x)
        return x


class ResidualBasedFusionBlock(nn.Module):
    """Attention-gated residual fusion of camera features into the lidar
    stream: fused = BN(lrelu(conv(cat))), out = fused·σ(att(fused)) + pcd."""

    def __init__(self, pcd_channels: int, img_channels: int):
        super().__init__()
        c = pcd_channels
        self.fuse_conv = ConvStage(Conv2d(c + img_channels, c, 3, padding=1), LeakyReLU(),
                                   BatchNorm2d(c))
        self.attention = nn.Sequential(Conv2d(c, c, 3, padding=1), BatchNorm2d(c),
                                       nn.ReLU(), Conv2d(c, c, 3, padding=1),
                                       BatchNorm2d(c), nn.Sigmoid())

    def forward(self, pcd_feature, img_feature):
        # the convolutions run in the camera features' (compute) dtype; the
        # residual keeps pcd_feature's (EPMF's sparse stem gives float32)
        fused = self.fuse_conv(torch.cat([pcd_feature.to(img_feature.dtype), img_feature], 1))
        a = self.attention
        att = conv_bn(fused, a[0], a[1], "relu")
        att = conv_bn(att, a[3], a[4], "sigmoid")
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
        """In inference on a tensor the kernel takes (`ops.aspp.aspp_takes`:
        CUDA, bf16, C a multiple of 128) outside a row split, the four
        conv branches run as one kernel (`ops.aspp.aspp_branches`) written
        into the NHWC concat buffer, the pooled branch broadcast into its
        first slice, and the 1x1 merge gives channels-last out. Otherwise
        (training, float32, the CPU, the split) as four convs and a
        concatenation, the dilated ones on an NCHW copy of x where C is 512
        or more: given channels-last bf16 x of that width at a batch's map
        size, cuDNN runs them on its direct kernel, 8-33x slower. The
        concatenation keeps the branches' layout."""
        gp = self.conv(spatial.spatial_mean(x))
        branches = (self.atrous_block1, self.atrous_block6, self.atrous_block12,
                    self.atrous_block18)
        if aspp_takes(x) and not torch.is_grad_enabled() and spatial.active() is None:
            n, c, h, w = x.shape
            cat = x.new_empty((n, h, w, 5 * c))
            cat[..., :c] = gp.view(n, 1, 1, c)
            aspp_branches(x, [b.weight for b in branches], [b.bias for b in branches],
                          tuple(b.dilation[0] for b in branches[1:]), cat)
            return conv_block(cat.permute(0, 3, 1, 2), self.conv_1x1_output)
        xd = x.contiguous() if x.shape[1] >= 512 else x
        pooled = gp.expand(-1, -1, *x.shape[2:])
        if xd.is_contiguous(memory_format=torch.channels_last):
            # an expanded tensor counts as NCHW, which would send the
            # concatenation and the decoder after it to NCHW
            pooled = pooled.contiguous(memory_format=torch.channels_last)
        cat = torch.cat([pooled, branches[0](x), *(b(xd) for b in branches[1:])], 1)
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

    def down(self, i: int, x, img, generator=None):
        """resBlock{i} and its fusion block: (fused pooled output, skip)."""
        with span("pmf.model.lidar_stream.encoder"):
            down, skip = getattr(self, f"resBlock{i}")(x, generator)
        with span("pmf.model.lidar_stream.fusion"):
            return getattr(self, f"fusionblock_{i}")(down, img), skip

    def forward(self, x, img_features, generator=None, remat: bool = False):
        """With `remat` each context block, each resBlock with its fusion
        block, the bottleneck and each upBlock are recomputed in the
        backward pass (`layers.remat_stage`). The context blocks, each
        resBlock, each fusion block, the bottleneck with ASPP (the head)
        and the upBlocks with the logits (the decoder) are spans
        pmf.model.lidar_stream.{context, encoder, fusion, head, decoder}."""
        g = generator
        run = lambda fn, *args: remat_stage(remat, fn, *args, generator=g)
        c = x
        with span("pmf.model.lidar_stream.context"):
            for block in (self.downCntx, self.downCntx2, self.downCntx3):
                c = run(block, c)
        skips = []
        for i in range(1, 5):
            c, skip = run(lambda c, img, i=i: self.down(i, c, img, g), c, img_features[i - 1])
            skips.append(skip)
        with span("pmf.model.lidar_stream.head"):
            up = run(lambda c: self.aspp(self.resBlock5(c, g)), c)
        with span("pmf.model.lidar_stream.decoder"):
            for block, skip in zip((self.upBlock1, self.upBlock2, self.upBlock3, self.upBlock4),
                                   reversed(skips)):
                up = run(block, up, skip, g)
            return torch.softmax(conv_block(up, self.logits).float(), dim=1)


class RGBDecoder(nn.Module):
    """Camera-stream FCN decoder: four conv → LeakyReLU → BN → bilinear ×2
    stages with skip concats, then a 3×3 conv and softmax."""

    def __init__(self, in_channels, nclasses: int = 20, base_channels: int = 64):
        super().__init__()
        bc = base_channels

        def stage(cin, kernel, padding):
            return ConvStage(Conv2d(cin, bc, kernel, padding=padding), LeakyReLU(),
                             BatchNorm2d(bc))

        self.up_4a = stage(in_channels[3], 3, 1)
        self.up_3a = stage(bc + in_channels[2], 3, 1)
        self.up_2a = stage(bc + in_channels[1], 3, 1)
        self.up_1a = stage(bc + in_channels[0], 1, 0)
        self.conv = Conv2d(bc, nclasses, 3, padding=1)

    def forward(self, inputs, remat: bool = False):
        """With `remat` each stage is recomputed in the backward pass
        (`layers.remat_stage`)."""
        up = remat_stage(remat, lambda x: upsample_bilinear(self.up_4a(x)), inputs[3])
        for block, skip in ((self.up_3a, inputs[2]), (self.up_2a, inputs[1]),
                            (self.up_1a, inputs[0])):
            up = remat_stage(remat, lambda u, s, block=block: upsample_bilinear(
                block(torch.cat([u, s], 1))), up, skip)
        return torch.softmax(conv_block(up, self.conv).float(), dim=1)


class PMFNet(GraphedNet):
    """Two-stream fusion net: forward(pcd [N, H, W, 5], img [N, H, W, 3]) →
    (lidar_probs, camera_probs), each [N, H, W, nclasses] float32.

    `dtype` is the compute dtype (float32 or bfloat16); parameters and BN
    statistics stay float32. In train mode the channel dropout draws its
    masks from `generator`, which forward then needs unless dropout_rate is
    0. With `remat` (pmf_tpu's train option) the stages of the three
    streams are recomputed in the backward pass instead of kept. The
    forward is the span pmf.model, holding one span a stream; at batch 1 in
    inference on the card it replays CUDA graphs (`models/graphs.py`).
    """

    graph_captures = 0
    graph_replays = 0

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

    def streams(self, pcd_feature, img_feature, generator=None, remat: bool = False):
        """The camera encoder (after the inputs' permutes and casts), the
        lidar stream and the camera decoder, a `yield` after each."""
        pcd = pcd_feature.permute(0, 3, 1, 2).to(self.dtype)
        img = img_feature.permute(0, 3, 1, 2).to(self.dtype)
        img_feats = self.camera_stream_encoder(img, generator, remat)
        yield
        lidar = self.lidar_stream(pcd, img_feats, generator, remat)
        yield
        camera = self.camera_stream_decoder(img_feats, remat)
        yield lidar.permute(0, 2, 3, 1), camera.permute(0, 2, 3, 1)


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
