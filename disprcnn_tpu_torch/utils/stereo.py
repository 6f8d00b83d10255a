"""Stereo geometry (counterpart of disprcnn_tpu/utils/stereo.py; reference
utils/stereo_utils.py:10-229).

- ``warp_right_to_left``: the right image seen from the left view through a
  dense disparity map (linear along x, zero outside the image).
- ``photometric_warp_error``: the L1 error of that warp against the left
  image, optionally under a mask.
The left/right box union is structures/stereo.py's; the end-point error is
ops/losses.py's.
"""
from __future__ import annotations

from typing import Optional

import torch


def warp_right_to_left(right: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
    """Sample right(y, x - d(y, x)) into the left view. right (H, W, C),
    disparity (H, W); samples outside [0, W - 1] are zero."""
    h, w, c = right.shape
    xs = torch.arange(w, dtype=disparity.dtype, device=disparity.device)[None, :] - disparity
    inside = (xs >= 0) & (xs <= w - 1)
    x = xs.clamp(0.0, w - 1.0)
    x0 = torch.floor(x).long().clamp(0, w - 2)
    fx = (x - x0)[..., None]
    v0 = torch.gather(right, 1, x0[..., None].expand(h, w, c))
    v1 = torch.gather(right, 1, (x0 + 1)[..., None].expand(h, w, c))
    out = v0 * (1 - fx) + v1 * fx
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def photometric_warp_error(left: torch.Tensor, right: torch.Tensor, disparity: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean L1 error of the warped right image against the left one (over
    the mask's pixels when given)."""
    err = (warp_right_to_left(right, disparity) - left).abs().mean(-1)
    if mask is not None:
        m = mask.to(err.dtype)
        return (err * m).sum() / m.sum().clamp_min(1.0)
    return err.mean()
