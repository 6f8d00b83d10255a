"""Feature Pyramid Network with this fork's deviations (counterpart of
disprcnn_tpu/models/backbone/fpn.py; reference modeling/backbone/fpn.py).

Three deviations from upstream maskrcnn-benchmark, all kept:
1. P5 is the bare 1x1 lateral (its 3x3 output conv is never applied, so it
   is not created here either);
2. top-down upsampling is bilinear with align_corners=False, not nearest;
3. the convolved result, not the pre-conv lateral sum, propagates down.
The top blocks: P6 as a 1x1/2 max pool of P5 (LastLevelMaxPool,
"maxpool"), or RetinaNet's LastLevelP6P7 ("p6p7": ``p6_s2``, a 3x3/2 conv
with padding 1 of C5, RETINANET.USE_C5's default, and ``p7_s2``, the same
of ReLU(P6)), or none. The laterals and outputs are named by the input's
position, not its level: over (C3, C4, C5) (``skip_c2``, RetinaNet's P3-P7)
they are lateral2..4 and output2..3, as the JAX package names them. NCHW.
With ``use_gn``
(MODEL.FPN.USE_GN) each lateral and each output conv loses its bias and is
followed by a GroupNorm (``lateral{i}_gn``, ``output{i}_gn``; Flax numbers
them GroupNorm_0.. in creation order: the laterals from P2 up, then the
outputs from the top down).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .fbnet import FBNet, stage_channels
from .resnet import GroupNorm, ResNet

TOP_BLOCKS = ("maxpool", "p6p7", "none")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 use_gn: bool = False, top_blocks: str = "maxpool"):
        super().__init__()
        if top_blocks not in TOP_BLOCKS:
            raise ValueError(f"top_blocks {top_blocks!r}: one of {TOP_BLOCKS}")
        self.num_levels = len(in_channels)
        self.use_gn, self.top_blocks = use_gn, top_blocks
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i + 2}", nn.Conv2d(cin, out_channels, 1, bias=not use_gn))
            if use_gn:
                self.add_module(f"lateral{i + 2}_gn", GroupNorm(out_channels))
        for i in range(self.num_levels - 1):
            self.add_module(f"output{i + 2}", nn.Conv2d(out_channels, out_channels, 3, padding=1,
                                                        bias=not use_gn))
            if use_gn:
                self.add_module(f"output{i + 2}_gn", GroupNorm(out_channels))
        if top_blocks == "p6p7":
            self.p6_s2 = nn.Conv2d(in_channels[-1], out_channels, 3, stride=2, padding=1)
            self.p7_s2 = nn.Conv2d(out_channels, out_channels, 3, stride=2, padding=1)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        return getattr(self, f"{name}_gn")(x) if self.use_gn else x

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """(C2, C3, C4, C5) -> (P2, P3, P4, P5, P6) with "maxpool"; (C3, C4,
        C5) -> (P3, ..., P7) with "p6p7"."""
        laterals = [self._conv(f"lateral{i + 2}", f) for i, f in enumerate(features)]
        last = laterals[-1]
        outs = [last]
        for i in range(self.num_levels - 2, -1, -1):
            lat = laterals[i]
            up = F.interpolate(last, size=lat.shape[-2:], mode="bilinear", align_corners=False)
            last = self._conv(f"output{i + 2}", lat + up)
            outs.insert(0, last)
        if self.top_blocks == "maxpool":
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        elif self.top_blocks == "p6p7":
            p6 = self.p6_s2(features[-1])
            outs += [p6, self.p7_s2(F.relu(p6))]
        return tuple(outs)


def fbnet_arch(body: str) -> str:
    """The arch of an FBNet[-<arch>] body name, read as the JAX package
    reads it (MODEL.FBNET.ARCH is not)."""
    return body.split("-")[1] if "-" in body else "default"


class ResNetFPNBackbone(nn.Module):
    """R-{50,101,152}-FPN or FBNet[-<arch>]-FPN (reference
    modeling/backbone/backbone.py). An FBNet body takes the four fbnet_*
    settings (MODEL.FBNET.SCALE_FACTOR, WIDTH_DIVISOR, DW_CONV_SKIP_BN,
    DW_CONV_SKIP_RELU) and no norm option; skip_c2 leaves the first map out
    of the FPN (RetinaNet's P3-P7)."""

    def __init__(self, body: str = "R-101", out_channels: int = 256, use_gn_body: bool = False,
                 use_gn_fpn: bool = False, top_blocks: str = "maxpool", skip_c2: bool = False,
                 fbnet_scale_factor: float = 1.0, fbnet_width_divisor: int = 1,
                 fbnet_dw_skip_bn: bool = True, fbnet_dw_skip_relu: bool = True):
        super().__init__()
        self.skip_c2 = skip_c2
        if body.startswith("FBNet"):
            arch = fbnet_arch(body)
            self.body = FBNet(arch, scale_factor=fbnet_scale_factor,
                              width_divisor=fbnet_width_divisor, dw_skip_bn=fbnet_dw_skip_bn,
                              dw_skip_relu=fbnet_dw_skip_relu)
            cins = stage_channels(arch, fbnet_scale_factor, fbnet_width_divisor)
        else:
            self.body = ResNet(body=body, use_gn=use_gn_body)
            cins = (256, 512, 1024, 2048)
        self.fpn = FPN(cins[1:] if skip_c2 else cins, out_channels, use_gn=use_gn_fpn,
                       top_blocks=top_blocks)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        cs = self.body(x)
        return self.fpn(cs[1:] if self.skip_c2 else cs)
