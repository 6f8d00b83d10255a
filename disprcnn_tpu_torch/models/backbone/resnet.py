"""ResNet body with frozen batch norm or GroupNorm (counterpart of
disprcnn_tpu/models/backbone/resnet.py; reference modeling/backbone/resnet.py).

Bottleneck stacks of R-50/101/152, stride in the 1x1 conv, C2..C5 outputs
for the FPN, or with ``num_stages`` 3 (C4) the first three stages alone
(the mono detector's single-map bodies R-x-C4 and R-x-C5). ``Stage5Head``
is res5 on pooled ROI features (the C4/C5 box head). NCHW inside. Every norm is a FrozenBatchNorm, or with
``use_gn`` (MODEL.BACKBONE.USE_GN) a trainable GroupNorm of 32 groups,
eps 1e-5, computed as Flax's: the variance is E[x^2] - E[x]^2 over each
group, clipped at 0 (``nn.GroupNorm`` takes it in two passes, which is
another rounding). ``freeze_at`` (MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
0-5, default 2) cuts the gradient as the JAX package's stop_gradient
does: after the stem when it is at least 1, after stage i (layer{i}) when
it is at least i + 1, so that the stem and the first freeze_at - 1
stages get none, their GroupNorms included.
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


GN_GROUPS = 32
GN_EPS = 1e-5


class GroupNorm(nn.Module):
    """Flax's GroupNorm on NCHW: each sample's channels in `groups`
    groups, normalized by the group's mean and its variance E[x^2] -
    E[x]^2 (clipped at 0), then y = (x - mean) * (rsqrt(var + eps) *
    weight) + bias, in Flax's order of operations."""

    def __init__(self, channels: int, groups: int = GN_GROUPS, eps: float = GN_EPS):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.reshape(n, self.groups, -1)
        mean = g.mean(-1)
        var = ((g * g).mean(-1) - mean * mean).clamp_min(0.0)
        per_channel = lambda t: t.repeat_interleave(c // self.groups, dim=1).reshape(
            n, c, *(1,) * (x.dim() - 2))
        shape = (1, c) + (1,) * (x.dim() - 2)
        mul = per_channel(torch.rsqrt(var + self.eps)) * self.weight.reshape(shape)
        return (x - per_channel(mean)) * mul + self.bias.reshape(shape)


def norm_layer(use_gn: bool, channels: int) -> nn.Module:
    return GroupNorm(channels) if use_gn else FrozenBatchNorm(channels)


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, bottleneck_channels: int, out_channels: int,
                 stride: int = 1, stride_in_1x1: bool = True, dilation: int = 1,
                 use_gn: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if stride != 1 or in_channels != out_channels:
            self.downsample_conv = _conv(in_channels, out_channels, 1, stride)
            self.downsample_bn = norm_layer(use_gn, out_channels)
        else:
            self.downsample_conv = self.downsample_bn = None
        self.conv1 = _conv(in_channels, bottleneck_channels, 1, s1)
        self.bn1 = norm_layer(use_gn, bottleneck_channels)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, s3, dilation)
        self.bn2 = norm_layer(use_gn, bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1)
        self.bn3 = norm_layer(use_gn, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


class Stem(nn.Module):
    def __init__(self, out_channels: int = 64, use_gn: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, out_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = norm_layer(use_gn, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        # Caffe-style 3x3/2 max pool with padding 0 and CEIL mode (this
        # fork's resnet.py:337), not torchvision's pad-1 pool
        return F.max_pool2d(x, 3, stride=2, padding=0, ceil_mode=True)


def body_blocks(body: str) -> Tuple[int, ...]:
    """The blocks a stage of a ResNet body name, its -FPN, -C4 or -C5
    suffix stripped."""
    return STAGE_BLOCKS[body.replace("-FPN", "").replace("-C4", "").replace("-C5", "")]


class ResNet(nn.Module):
    """-> (C2, C3, C4, C5) NCHW feature maps, the first `num_stages` of them."""

    def __init__(self, body: str = "R-101", stem_out_channels: int = 64,
                 res2_out_channels: int = 256, width_per_group: int = 64,
                 stride_in_1x1: bool = True, use_gn: bool = False, num_stages: int = 4,
                 freeze_at: int = 2):
        super().__init__()
        self.freeze_at = freeze_at
        blocks = body_blocks(body)[:num_stages]
        self.stem = Stem(stem_out_channels, use_gn)
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
                    stride_in_1x1=stride_in_1x1, use_gn=use_gn,
                ))
                names.append(name)
            self.block_names.append(names)
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        outs = []
        for stage, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            if self.freeze_at >= stage + 2:
                x = x.detach()
            outs.append(x)
        return tuple(outs)


class Stage5Head(nn.Module):
    """res5 on pooled ROI features (reference ResNet50Conv5ROIFeatureExtractor,
    the C4 box head's path): (N, in_channels, r, r) -> (N, 2048, r/2, r/2),
    the first block at stride 2, blocks named layer4_{b} as the JAX
    package's. in_channels is the body's last map's: 1024 for C4, 2048 for
    C5."""

    def __init__(self, body: str = "R-50", in_channels: int = 1024, width_per_group: int = 64,
                 stride_in_1x1: bool = True, use_gn: bool = False):
        super().__init__()
        self.block_names = []
        for b in range(body_blocks(body)[3]):
            name = f"layer4_{b}"
            self.add_module(name, Bottleneck(
                in_channels if b == 0 else 2048, width_per_group * 8, 2048,
                stride=2 if b == 0 else 1, stride_in_1x1=stride_in_1x1, use_gn=use_gn))
            self.block_names.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x
