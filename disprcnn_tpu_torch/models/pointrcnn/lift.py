"""The pseudo-LiDAR lift (counterpart of
disprcnn_tpu/models/pointrcnn/lift.py). The iDispNet slice needs only the
integer box expansion that its crops share with the lift; the lift itself
comes with the PointRCNN slice."""
from __future__ import annotations

import torch


def expand_box_to_integer(box: torch.Tensor) -> torch.Tensor:
    """floor x1/y1, ceil x2/y2 (reference utils/stereo_utils.py)."""
    return torch.stack([torch.floor(box[..., 0]), torch.floor(box[..., 1]),
                        torch.ceil(box[..., 2]), torch.ceil(box[..., 3])], dim=-1)
