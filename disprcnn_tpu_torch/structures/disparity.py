"""Disparity maps: a resize rescales the VALUES by the width ratio
(counterpart of disprcnn_tpu/structures/disparity.py; reference
structures/disparity.py:12-90, the value rescale at line 60).

Disparity is proportional to the width, so a spatial resize also scales the
values. Functions take (H, W) or batched (..., H, W) tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_disparity(disp: torch.Tensor, dst_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) disparity to (..., h', w'), half-pixel
    centres, antialiased where it shrinks (jax.image.resize's "bilinear"),
    the values multiplied by w'/W."""
    lead, (h, w) = disp.shape[:-2], disp.shape[-2:]
    x = disp.reshape(-1, 1, h, w)
    out = F.interpolate(x, size=tuple(dst_hw), mode="bilinear", align_corners=False,
                        antialias=dst_hw[0] < h or dst_hw[1] < w)
    return out.reshape(*lead, *dst_hw) * (dst_hw[1] / w)


def crop_disparity(disp: torch.Tensor, box) -> torch.Tensor:
    """Crop (x1, y1, x2, y2) of an (..., H, W) map; values unchanged
    (reference DisparityMap.crop)."""
    x1, y1, x2, y2 = (int(v) for v in box)
    return disp[..., y1:y2, x1:x2]


def shift_disparity(disp: torch.Tensor, offset) -> torch.Tensor:
    """Add the left/right crop x-offset (x1 - x1') that turns full-image
    disparity into ROI disparity (reference
    tools/kitti_object/generate_psmnet_input_inf.py and psmnet/inference.py)."""
    return disp + offset
