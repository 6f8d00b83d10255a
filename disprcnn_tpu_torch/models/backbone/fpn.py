"""Feature Pyramid Network with this fork's deviations (counterpart of
disprcnn_tpu/models/backbone/fpn.py; reference modeling/backbone/fpn.py).

Three deviations from upstream maskrcnn-benchmark, all kept:
1. P5 is the bare 1x1 lateral (its 3x3 output conv is never applied, so it
   is not created here either);
2. top-down upsampling is bilinear with align_corners=False, not nearest;
3. the convolved result, not the pre-conv lateral sum, propagates down.
P6 is a 1x1/2 max pool of P5 (LastLevelMaxPool). NCHW. With ``use_gn``
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

from .resnet import GroupNorm, ResNet


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 use_gn: bool = False):
        super().__init__()
        self.num_levels = len(in_channels)
        self.use_gn = use_gn
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i + 2}", nn.Conv2d(cin, out_channels, 1, bias=not use_gn))
            if use_gn:
                self.add_module(f"lateral{i + 2}_gn", GroupNorm(out_channels))
        for i in range(self.num_levels - 1):
            self.add_module(f"output{i + 2}", nn.Conv2d(out_channels, out_channels, 3, padding=1,
                                                        bias=not use_gn))
            if use_gn:
                self.add_module(f"output{i + 2}_gn", GroupNorm(out_channels))

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        return getattr(self, f"{name}_gn")(x) if self.use_gn else x

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """(C2, C3, C4, C5) -> (P2, P3, P4, P5, P6)."""
        laterals = [self._conv(f"lateral{i + 2}", f) for i, f in enumerate(features)]
        last = laterals[-1]
        outs = [last]
        for i in range(self.num_levels - 2, -1, -1):
            lat = laterals[i]
            up = F.interpolate(last, size=lat.shape[-2:], mode="bilinear", align_corners=False)
            last = self._conv(f"output{i + 2}", lat + up)
            outs.insert(0, last)
        outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return tuple(outs)


class ResNetFPNBackbone(nn.Module):
    """R-{50,101,152}-FPN (reference modeling/backbone/backbone.py)."""

    def __init__(self, body: str = "R-101", out_channels: int = 256, use_gn_body: bool = False,
                 use_gn_fpn: bool = False):
        super().__init__()
        self.body = ResNet(body=body, use_gn=use_gn_body)
        self.fpn = FPN([256, 512, 1024, 2048], out_channels, use_gn=use_gn_fpn)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.fpn(self.body(x))
