"""PMFNet with the ResNet50 camera encoder, in plain PyTorch, and its FLOP
count.

The encoder is torchvision's ResNet50 (bottleneck blocks of widths 64, 128,
256 and 512 expanded four times; the stride on each stage's 3x3 conv) with
PMF's changes, as `nets.ResNet34` has them: the 7x7 stem has stride 1, so
only the max pool downsamples before layer1, and channel dropout follows
layer3 and layer4. Module names are torchvision's, so one state_dict loads
into this net and the port's `PMFNet(image_backbone="resnet50")`.

The rest of the net is `nets.py`'s, by import: the SalsaNext lidar stream
with its four fusion blocks, here fed 256, 512, 1024 and 2048 camera
channels, and the camera decoder on a base of 64 (16 times the expansion,
as the port and pc_processor build it). Everything computes in float32;
`nets.set_fp8` makes the control of it.

Departures from the published description (ICEORY/PMF, `pmf_nuscenes.yaml`
with `img_backbone: resnet50`): none in the layers. As in `nets.py`, BN
is applied unfolded and the channel dropout draws from the generator
`forward` takes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from .flops import RULES
from .nets import BatchNorm2d, Conv2d, Dropout2d, LidarStream, RGBDecoder


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride, downsample):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(width * 4)
        self.downsample = nn.Sequential(Conv2d(cin, width * 4, 1, stride=stride, bias=False),
                                        BatchNorm2d(width * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet50(nn.Module):
    feature_channels = (256, 512, 1024, 2048)

    def __init__(self, dropout_rate: float = 0.2):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            blocks = []
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(Bottleneck(cin, width, stride, i == 0))
                cin = width * 4
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


class PMFNetR50(nn.Module):
    """forward(pcd [B, H, W, 5], img [B, H, W, 3], g) → (lidar, camera)
    class probabilities [B, H, W, C]."""

    def __init__(self, nclasses=17, base_channels=32, dropout_rate=0.2):
        super().__init__()
        self.camera_stream_encoder = ResNet50(dropout_rate)
        chans = ResNet50.feature_channels
        self.camera_stream_decoder = RGBDecoder(chans, nclasses, 16 * Bottleneck.expansion)
        self.lidar_stream = LidarStream(chans, nclasses, base_channels, dropout_rate)

    def forward(self, pcd, img, g=None):
        pcd, img = pcd.permute(0, 3, 1, 2).float(), img.permute(0, 3, 1, 2).float()
        feats = self.camera_stream_encoder(img, g)
        lidar = self.lidar_stream(pcd, feats, g)
        camera = self.camera_stream_decoder(feats)
        return lidar.permute(0, 2, 3, 1), camera.permute(0, 2, 3, 1)


def count(batch: int, h: int, w: int, nclasses: int, base_channels: int, train: bool) -> int:
    """The FLOPs of one forward (eval) or forward and backward (train) of
    PMFNetR50 on a [batch, h, w] view, by `flops.py`'s definition and rules,
    counted on the `meta` device."""
    with torch.device("meta"):
        model = PMFNetR50(nclasses, base_channels)
        pcd = torch.zeros(batch, h, w, 5)
        img = torch.zeros(batch, h, w, 3)
    model.train(train)
    with FlopCounterMode(display=False, custom_mapping=RULES) as counter:
        with torch.set_grad_enabled(train):
            lidar, cam = model(pcd, img)
            if train:
                (lidar.sum() + cam.sum()).backward()
    return counter.get_total_flops()
