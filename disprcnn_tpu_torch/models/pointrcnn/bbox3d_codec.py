"""Bin-based 3D box decoding, PointRCNN style (counterpart of the decode
half of disprcnn_tpu/models/pointrcnn/bbox3d_codec.py; reference
lib/utils/bbox_transform.py). A regression vector is laid out
[x_bins | z_bins | (x_res | z_res if xz_fine) | y_offset | ry_bins | ry_res
| size_res(3)].
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class CodecCfg(NamedTuple):
    loc_scope: float = 3.0
    loc_bin_size: float = 0.5
    num_head_bin: int = 12
    xz_fine: bool = False
    ry_fine: bool = False

    @property
    def per_loc_bin_num(self) -> int:
        return int(self.loc_scope / self.loc_bin_size) * 2

    @property
    def reg_channels(self) -> int:
        n = self.per_loc_bin_num * (4 if self.xz_fine else 2)
        return n + 1 + self.num_head_bin * 2 + 3


def remainder(x: torch.Tensor, y: float) -> torch.Tensor:
    """x mod y with the sign of y, computed as jnp.remainder does: the
    truncated remainder, plus y where its sign differs from y's."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _pick(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(block, 1, idx[:, None])[:, 0]


def decode(base_xyz: torch.Tensor, pred: torch.Tensor, anchor_size: torch.Tensor,
           cfg: CodecCfg, base_ry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """base_xyz (N, 3) anchor points or roi centres, pred (N, C) -> (N, 7)
    xyzhwl_ry; y is the box centre (callers shift it to the bottom face).
    With base_ry the box is decoded in each roi's canonical frame and
    rotated back by its yaw."""
    nbin = cfg.per_loc_bin_num
    x_bin = torch.argmax(pred[:, 0:nbin], dim=1)  # the first of equal maxima
    z_bin = torch.argmax(pred[:, nbin:nbin * 2], dim=1)
    pos_x = x_bin * cfg.loc_bin_size + cfg.loc_bin_size / 2 - cfg.loc_scope
    pos_z = z_bin * cfg.loc_bin_size + cfg.loc_bin_size / 2 - cfg.loc_scope
    off = nbin * 2
    if cfg.xz_fine:
        pos_x = pos_x + _pick(pred[:, off:off + nbin], x_bin) * cfg.loc_bin_size
        pos_z = pos_z + _pick(pred[:, off + nbin:off + 2 * nbin], z_bin) * cfg.loc_bin_size
        off += 2 * nbin
    pos_y = base_xyz[:, 1] + pred[:, off]
    off += 1
    nh = cfg.num_head_bin
    ry_bin = torch.argmax(pred[:, off:off + nh], dim=1)
    ry_res = _pick(pred[:, off + nh:off + 2 * nh], ry_bin)
    if cfg.ry_fine:
        per = (math.pi / 2) / nh
        ry = ry_bin * per + per / 2 + ry_res * (per / 2) - math.pi / 4
    else:
        per = (2 * math.pi) / nh
        ry = remainder(ry_bin * per + ry_res * (per / 2), 2 * math.pi)
        ry = torch.where(ry > math.pi, ry - 2 * math.pi, ry)
    off += 2 * nh
    hwl = pred[:, off:off + 3] * anchor_size + anchor_size
    x, z = pos_x, pos_z
    if base_ry is not None:
        c, s = torch.cos(-base_ry), torch.sin(-base_ry)
        x, z = pos_x * c - pos_z * s, pos_x * s + pos_z * c
        ry = ry + base_ry
    return torch.cat([(x + base_xyz[:, 0])[:, None], pos_y[:, None],
                      (z + base_xyz[:, 2])[:, None], hwl, ry[:, None]], dim=-1)
