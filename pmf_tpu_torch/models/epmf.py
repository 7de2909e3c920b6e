"""EPMFNet, the efficient PMF of the TPAMI extension (counterpart of
`pmf_tpu/models/epmf.py`).

  * SparseVariantConv: a conv of the masked input with the Conv's own bias
    and an extra module-level `bias`, the output multiplied by the mask
    dilated as the conv's window moves (a max pool); the reference's unused
    1/count normalizer is left out, as its executed code leaves it out;
  * SparseResContextBlock: the mask recomputed from |x|, stride 2 in
    downCntx3, so the lidar stream runs at half resolution;
  * SalsaNextFusionV2: the camera features fused in before each resBlock,
    ASPP on the bottleneck, extraUpSample (conv → LReLU → BN → PixelShuffle)
    back to full resolution; it returns the probabilities and the
    bottleneck;
  * RGBDecoderV2: the camera decoder fed ASPP(layer4) and the upsampled
    lidar bottleneck.

Module names are the reference's (extraUpSample.{0,2}, conv{i}.conv and
conv{i}.bias), so a pc_processor checkpoint loads as it is. In bfloat16 the
dtypes follow pmf_tpu's: a SparseVariantConv's output is float32 (the bf16
conv plus the float32 extra bias), every conv and BN output is bf16 again.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import PixelShuffle
from ..parallel import spatial
from ..utils.spans import span
from .graphs import GraphedNet
from .layers import BatchNorm2d, Conv2d, conv_block, leaky_relu, remat_stage
from .pmf import ASPP, ConvStage, LeakyReLU, ResidualBasedFusionBlock, RGBDecoder
from .resnet import ResNetEncoder
from .salsanext import ResBlock, UpBlock


def _dilate_mask(mask, kernel: int, stride: int, dilation: int, padding: int):
    """The mask [N, 1, H, W] after the conv's window: zero-padded by the
    conv's padding, then max-pooled with its kernel, stride and dilation
    (under a row split the padding rows are zeros fetched with the window).
    No gradient flows through it (it starts at a comparison)."""
    with torch.no_grad():
        if spatial.active() is None:
            m = F.pad(mask, (padding,) * 4)
            return F.max_pool2d(m, kernel, stride=stride, dilation=dilation)
        pool = lambda block: F.max_pool2d(F.pad(block, (padding, padding, 0, 0)), kernel,
                                          stride=stride, dilation=dilation)
        return spatial.window_op(mask, kernel, stride, dilation, padding, pool)


class SparseVariantConv(nn.Module):
    """Sparsity-aware conv: forward(x, mask) → (conv(x·mask) + bias) · mask',
    mask'. The conv runs in x's dtype; the extra bias is float32, so is the
    output."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, padding: int = 1,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, mask):
        c = self.conv
        new_mask = _dilate_mask(mask, c.kernel_size[0], c.stride[0], c.dilation[0], c.padding[0])
        y = c(x * mask) + self.bias[:, None, None]
        return y * new_mask, new_mask


class SparseResContextBlock(nn.Module):
    """The sparse context block: 3×3 shortcut (stride 1 or 2), then 3×3 and
    3×3 dilation 2, each BN after its LeakyReLU, re-masked at the end.
    forward(x, dtype): x is cast to the compute dtype `dtype`."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = SparseVariantConv(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = SparseVariantConv(cout, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv3 = SparseVariantConv(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x, dtype: torch.dtype):
        x = x.to(dtype)
        mask = (x != 0).any(dim=1, keepdim=True).to(dtype)
        shortcut, mask = self.conv1(x, mask)
        shortcut = leaky_relu(shortcut)
        resA, mask = self.conv2(shortcut.to(dtype), mask)
        resA1 = self.bn1(leaky_relu(resA), dtype)
        resA, mask = self.conv3(resA1, mask)
        resA2 = self.bn2(leaky_relu(resA), dtype)
        return (shortcut + resA2) * mask


def extra_upsample(cin: int, cout: int) -> nn.Sequential:
    """conv 3×3 → LeakyReLU → BN → PixelShuffle(2), under the reference's
    nn.Sequential indices."""
    return ConvStage(Conv2d(cin, cout, 3, padding=1), LeakyReLU(), BatchNorm2d(cout),
                     PixelShuffle(2))


class SalsaNextFusionV2(nn.Module):
    """The EPMF lidar stream. forward(x [N, 5, H, W] in the compute dtype,
    img_features) → (probabilities [N, nclasses, H, W] float32, the ASPP
    bottleneck [N, 8·bc, H/32, W/32])."""

    def __init__(self, img_channels, nclasses: int = 20, base_channels: int = 32,
                 in_channels: int = 5, dropout_rate: float = 0.2):
        super().__init__()
        bc, p = base_channels, dropout_rate
        self.downCntx = SparseResContextBlock(in_channels, bc)
        self.downCntx2 = SparseResContextBlock(bc, bc)
        self.downCntx3 = SparseResContextBlock(bc, bc, stride=2)
        self.fusionblock_1 = ResidualBasedFusionBlock(bc, img_channels[0])
        self.resBlock1 = ResBlock(bc, 2 * bc, p, drop_out=False)
        self.fusionblock_2 = ResidualBasedFusionBlock(2 * bc, img_channels[1])
        self.resBlock2 = ResBlock(2 * bc, 4 * bc, p)
        self.fusionblock_3 = ResidualBasedFusionBlock(4 * bc, img_channels[2])
        self.resBlock3 = ResBlock(4 * bc, 8 * bc, p)
        self.fusionblock_4 = ResidualBasedFusionBlock(8 * bc, img_channels[3])
        self.resBlock4 = ResBlock(8 * bc, 8 * bc, p)
        self.resBlock5 = ResBlock(8 * bc, 8 * bc, p, pooling=False)
        self.aspp = ASPP(8 * bc, 8 * bc)
        self.upBlock1 = UpBlock(8 * bc, 8 * bc, 4 * bc, p)
        self.upBlock2 = UpBlock(4 * bc, 8 * bc, 4 * bc, p)
        self.upBlock3 = UpBlock(4 * bc, 4 * bc, 2 * bc, p)
        self.upBlock4 = UpBlock(2 * bc, 2 * bc, bc, p, drop_out=False)
        self.extraUpSample = extra_upsample(bc, 4 * bc)
        self.logits = Conv2d(bc, nclasses, 1)

    def down(self, i: int, x, img, dtype: torch.dtype, generator=None):
        """fusionblock_{i} and resBlock{i} after it, in `dtype`: (pooled
        output, skip)."""
        with span("pmf.model.lidar_stream.fusion"):
            fused = getattr(self, f"fusionblock_{i}")(x, img)
        with span("pmf.model.lidar_stream.encoder"):
            return getattr(self, f"resBlock{i}")(fused.to(dtype), generator)

    def forward(self, x, img_features, generator=None, remat: bool = False):
        """With `remat` each context block, each fusion block with its
        resBlock, the bottleneck, each upBlock and the full-resolution head
        are recomputed in the backward pass (`layers.remat_stage`). The
        sparse context blocks, each fusion block, each resBlock, the
        bottleneck with ASPP (the head) and the upBlocks with the
        full-resolution logits (the decoder) are spans
        pmf.model.lidar_stream.{context, fusion, encoder, head, decoder}."""
        g, dt = generator, x.dtype
        run = lambda fn, *args: remat_stage(remat, fn, *args, generator=g)
        c = x
        with span("pmf.model.lidar_stream.context"):
            for block in (self.downCntx, self.downCntx2, self.downCntx3):
                c = run(block, c, dt)
        skips = []
        for i in range(1, 5):
            c, skip = run(lambda c, img, i=i: self.down(i, c, img, dt, g), c, img_features[i - 1])
            skips.append(skip)
        with span("pmf.model.lidar_stream.head"):
            down5c = run(lambda c: self.aspp(self.resBlock5(c, g)), c)
        with span("pmf.model.lidar_stream.decoder"):
            up = down5c
            for block, skip in zip((self.upBlock1, self.upBlock2, self.upBlock3, self.upBlock4),
                                   reversed(skips)):
                up = run(block, up, skip, g)
            logits = run(lambda up: conv_block(self.extraUpSample(up), self.logits).float(), up)
            return torch.softmax(logits, dim=1), down5c


class RGBDecoderV2(RGBDecoder):
    """RGBDecoder fed the lidar→camera fusion: its first stage takes
    ASPP(layer4) ⊕ extraUpSample(lidar bottleneck) in place of layer4."""

    def __init__(self, in_channels, nclasses: int = 20, base_channels: int = 64,
                 lidar_base_channels: int = 32):
        lbc = lidar_base_channels
        super().__init__([*in_channels[:3], 2 * lbc + in_channels[3]], nclasses, base_channels)
        self.extraUpSample = extra_upsample(8 * lbc, 8 * lbc)
        self.aspp = ASPP(in_channels[3], in_channels[3])

    def fuse(self, feature, lidar_feature):
        """The lidar bottleneck upsampled and ASPP(layer4), concatenated;
        each a span, pmf.model.camera_decoder.{lidar_upsample, aspp}."""
        with span("pmf.model.camera_decoder.lidar_upsample"):
            lid = self.extraUpSample(lidar_feature)
        with span("pmf.model.camera_decoder.aspp"):
            return torch.cat([lid, self.aspp(feature).to(lid.dtype)], 1)

    def forward(self, inputs, lidar_feature, remat: bool = False):
        fuse = remat_stage(remat, self.fuse, inputs[3], lidar_feature)
        return super().forward([*inputs[:3], fuse], remat)


class EPMFNet(GraphedNet):
    """Efficient PMF: forward(pcd [N, H, W, 5], img [N, H, W, 3]) →
    (lidar_probs, camera_probs), each [N, H, W, nclasses] float32; H and W
    must be multiples of 32 (the lidar stream runs at half resolution and
    pools 4 times; A2D2's eval view is 480 rows).

    `dtype` is the compute dtype (float32 or bfloat16); parameters and BN
    statistics stay float32. In train mode the channel dropout draws its
    masks from `generator`, which forward then needs unless dropout_rate is
    0. With `remat` the stages of the three streams are recomputed in the
    backward pass instead of kept (PMFNet's). The forward is the span
    pmf.model with one span a stream, and replays CUDA graphs where
    PMFNet's does (`models/graphs.py`).
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
        self.camera_stream_decoder = RGBDecoderV2(
            chans, nclasses, base_channels=self.camera_stream_encoder.expansion * 16,
            lidar_base_channels=base_channels)
        self.lidar_stream = SalsaNextFusionV2(chans, nclasses, base_channels,
                                              dropout_rate=dropout_rate)

    def forward(self, pcd_feature, img_feature, generator=None, remat: bool = False):
        if spatial.height(pcd_feature, 1) % 32 or pcd_feature.shape[2] % 32:
            raise ValueError(f"EPMFNet needs sizes divisible by 32: {tuple(pcd_feature.shape)}")
        return super().forward(pcd_feature, img_feature, generator, remat)

    def streams(self, pcd_feature, img_feature, generator=None, remat: bool = False):
        """PMFNet's three streams; the camera decoder also takes the lidar
        bottleneck."""
        pcd = pcd_feature.permute(0, 3, 1, 2).to(self.dtype)
        img = img_feature.permute(0, 3, 1, 2).to(self.dtype)
        img_feats = self.camera_stream_encoder(img, generator, remat)
        yield
        lidar, lidar_feature = self.lidar_stream(pcd, img_feats, generator, remat)
        yield
        camera = self.camera_stream_decoder(img_feats, lidar_feature, remat)
        yield lidar.permute(0, 2, 3, 1), camera.permute(0, 2, 3, 1)
