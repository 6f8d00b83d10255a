"""The PSMNet concat cost volume, plain PyTorch (counterpart of
disprcnn_tpu/models/psmnet/psmnet.py:build_cost_volume).

On the card the volume is never stored: the cost-volume conv kernel
(csrc/cost_volume_tc.cu) computes the conv from per-view tap planes of the
feature maps. This version is the kernel's plain reference and the CPU
path.
"""
from __future__ import annotations

import torch


def build_cost_volume(left: torch.Tensor, right: torch.Tensor, mindisp4: int,
                      maxdisp4: int) -> torch.Tensor:
    """(B, C, H, W) quarter-res features -> (B, 2C, D, H, W), D = maxdisp4 -
    mindisp4. Slice z (disparity i = mindisp4 + z) holds [left | right
    shifted right by i], both zero at the columns x where x - i is out of
    bounds: x >= i for i > 0, x < W + i for i < 0 (stackhourglass.py:117-128)."""
    w = left.shape[-1]
    cols = torch.arange(w, device=left.device)
    slices = []
    for i in range(mindisp4, maxdisp4):
        mask = ((cols >= i) & (cols < w + i)).to(left.dtype)
        slices.append(torch.cat([left * mask, torch.roll(right, i, dims=-1) * mask], dim=1))
    return torch.stack(slices, dim=2)
