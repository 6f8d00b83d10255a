"""DispModule: iDispNet on FPN ROI features (counterpart of
disprcnn_tpu/models/psmnet/dispmodule.py; reference
modeling/psmnet/dispmodule.py, the MODEL.DISPNET_ON branch of DispRCNN).

Instead of the siamese tower on 224^2 image crops, each view's ROI is
pooled from every FPN level at ``resolution`` (RoIAlign, sampling ratio 2)
and the levels' channels are concatenated; ``reduce{i}`` (3x3 ConvBN +
ReLU per CONV_LAYERS entry) and the 1x1 ``reduce_out`` bring them to 32
channels. PSMNet's 3D trunk (psmnet.CostVolumeTrunk: the cost volume with
dres0_0, dres0_1, dres1_*, the hourglasses dres2..dres4 and the
classifiers) then runs at the ROI resolution over disparities [mindisp,
maxdisp) / stride, stride = disp_resolution // resolution, and the
soft-argmin regresses the disparity at disp_resolution^2.

The JAX package follows the reference's documented intent, its exact
graph being dead code (tests/test_dispmodule_dead.py); so does the port.
Names are the Flax names. On the card the trunk takes the same kernels as
PSMNet's (csrc/cost_volume_tc.cu, conv3d_tc.cu, conv3d.cu,
softargmin.cu) at these shapes; ``reduce{i}`` is the 2D ConvBN, which
takes the 2D conv kernel only at 32 or 64 output channels (else cuDNN,
as XLA runs it in the JAX package).

Train mode (``self.training``): batch-statistics BN over every row of the
call, as Flax's, and the three deep-supervision disparities of the plain
soft-argmin; the caller masks the loss, not the rows.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.roi_align import roi_align_batched
from .psmnet import ConvBN, CostVolumeTrunk

SAMPLING_RATIO = 2  # the JAX DispModule's pooler (dispmodule.py:72)


def expand_left_right_freex(left: torch.Tensor, right: torch.Tensor,
                            image_w: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views of each (R, 4) box pair get the width max(w_l, w_r),
    capped so that the left box stays inside the image (dispmodule.py:90-104)."""
    lw = left[:, 2] - left[:, 0]
    rw = right[:, 2] - right[:, 0]
    w = torch.minimum(torch.maximum(lw, rw), image_w - left[:, 0])
    le, re = left.clone(), right.clone()
    le[:, 2] = left[:, 0] + w
    re[:, 2] = right[:, 0] + w
    return le, re


def roi_resolution_keep(boxes: torch.Tensor, resolutions: Sequence[int], resolution: int,
                        method: str = "nearest") -> torch.Tensor:
    """(R, 4) boxes -> (R,) bool: the ROIs that the area rule of the
    multi-resolution variant (dispmodule.ROILevelMapper:18-49) routes to
    `resolution` among `resolutions`."""
    areas = [(r * 4) ** 2 for r in resolutions]
    i = list(resolutions).index(resolution)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    last = len(resolutions) - 1
    if method == "nearest":
        lo = -float("inf") if i == 0 else (areas[i] + areas[i - 1]) / 2
        hi = float("inf") if i == last else (areas[i] + areas[i + 1]) / 2
    else:
        lo = -float("inf") if i == 0 else areas[i - 1]
        hi = float("inf") if i == last else areas[i]
    return (area >= lo) & (area < hi)


class DispModule(CostVolumeTrunk):
    """forward(left_feats, right_feats, left_boxes, right_boxes, batch_idx)
    -> (R, disp_resolution, disp_resolution) disparity, or in train mode
    the three deep-supervision disparities."""

    def __init__(self, in_channels: int = 256, maxdisp: int = 48, mindisp: int = -48,
                 resolution: int = 28, disp_resolution: int = 112,
                 pooler_scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
                 conv_layers: Sequence[int] = (256,)):
        super().__init__()
        self.resolution, self.disp_resolution = resolution, disp_resolution
        self.pooler_scales = tuple(pooler_scales)
        self.conv_layers = tuple(conv_layers)
        cin = in_channels * len(self.pooler_scales)
        for i, c in enumerate(self.conv_layers):
            self.add_module(f"reduce{i}", ConvBN(cin, c, 3))
            cin = c
        self.reduce_out = nn.Conv2d(cin, 32, 1, bias=False)
        self._build_trunk(maxdisp, mindisp, 3)
        self.eval()

    def pool(self, feats: Sequence[torch.Tensor], boxes: torch.Tensor,
             batch_idx: torch.Tensor) -> torch.Tensor:
        """Every ROI on every level (no per-level selection, no host sync),
        the levels' channels concatenated -> (R, L * C, r, r)."""
        return torch.cat([roi_align_batched(f, boxes, batch_idx, self.resolution,
                                            spatial_scale=s, sampling_ratio=SAMPLING_RATIO)
                          for f, s in zip(feats, self.pooler_scales)], dim=1)

    def forward(self, left_feats: Sequence[torch.Tensor], right_feats: Sequence[torch.Tensor],
                left_boxes: torch.Tensor, right_boxes: torch.Tensor, batch_idx: torch.Tensor):
        """left_feats, right_feats: the FPN levels P2..P5 (B, C, H_l, W_l)
        of each view; left_boxes, right_boxes (R, 4) width-aligned boxes;
        batch_idx (R,) each ROI's image."""
        r = left_boxes.shape[0]
        x = torch.cat([self.pool(left_feats, left_boxes, batch_idx),
                       self.pool(right_feats, right_boxes, batch_idx)], dim=0)
        for i in range(len(self.conv_layers)):
            x = getattr(self, f"reduce{i}")(x, relu=True)
        x = self.reduce_out(x)
        stride = self.disp_resolution // self.resolution
        return self._regress(x[:r], x[r:], stride, (self.disp_resolution,) * 2)
