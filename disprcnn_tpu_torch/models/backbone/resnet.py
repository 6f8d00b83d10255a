"""ResNet body with frozen batch norm (counterpart of
disprcnn_tpu/models/backbone/resnet.py; reference modeling/backbone/resnet.py).

Bottleneck stacks of R-50/101/152, stride in the 1x1 conv, C2..C5 outputs
for the FPN. NCHW inside; no GN. The JAX package's freeze_at = 2, the
default of every config, is a fixed boundary here: no gradient flows back
past layer1's output (C2), so the stem and layer1 get none.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

STAGE_BLOCKS = {
    "R-50": (3, 4, 6, 3),
    "R-101": (3, 4, 23, 3),
    "R-152": (3, 8, 36, 3),
}


class FrozenBatchNorm(nn.Module):
    """y = x * scale/sqrt(var + eps) + (bias - mean * scale/sqrt(var + eps)).

    eps is 1e-5: the reference's FrozenBatchNorm2d is nn.BatchNorm2d at eval
    (its own forward is commented out). The constants are buffers, not
    parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        return x * mul[:, None, None] + add[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, bottleneck_channels: int, out_channels: int,
                 stride: int = 1, stride_in_1x1: bool = True, dilation: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if stride != 1 or in_channels != out_channels:
            self.downsample_conv = _conv(in_channels, out_channels, 1, stride)
            self.downsample_bn = FrozenBatchNorm(out_channels)
        else:
            self.downsample_conv = self.downsample_bn = None
        self.conv1 = _conv(in_channels, bottleneck_channels, 1, s1)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, s3, dilation)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1)
        self.bn3 = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


class Stem(nn.Module):
    def __init__(self, out_channels: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, out_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        # Caffe-style 3x3/2 max pool with padding 0 and CEIL mode (this
        # fork's resnet.py:337), not torchvision's pad-1 pool
        return F.max_pool2d(x, 3, stride=2, padding=0, ceil_mode=True)


class ResNet(nn.Module):
    """-> (C2, C3, C4, C5) NCHW feature maps."""

    def __init__(self, body: str = "R-101", stem_out_channels: int = 64,
                 res2_out_channels: int = 256, width_per_group: int = 64,
                 stride_in_1x1: bool = True):
        super().__init__()
        blocks = STAGE_BLOCKS[body.replace("-FPN", "")]
        self.stem = Stem(stem_out_channels)
        self.block_names = []
        in_ch = stem_out_channels
        for stage, n_blocks in enumerate(blocks):
            out_ch = res2_out_channels * 2 ** stage
            mid_ch = width_per_group * 2 ** stage
            names = []
            for i in range(n_blocks):
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, Bottleneck(
                    in_ch if i == 0 else out_ch, mid_ch, out_ch,
                    stride=(1 if stage == 0 else 2) if i == 0 else 1,
                    stride_in_1x1=stride_in_1x1,
                ))
                names.append(name)
            self.block_names.append(names)
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        outs = []
        for stage, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            if stage == 0:  # freeze_at = 2: nothing reaches layer1 or the stem
                x = x.detach()
            outs.append(x)
        return tuple(outs)
