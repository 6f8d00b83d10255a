"""Bin-based 3D box decoding and its training loss, PointRCNN style
(counterpart of disprcnn_tpu/models/pointrcnn/bbox3d_codec.py; reference
lib/utils/bbox_transform.py, loss_utils.get_reg_loss). A regression vector
is laid out
[x_bins | z_bins | (x_res | z_res if xz_fine) | y_offset | ry_bins | ry_res
| size_res(3)].

A bf16 prediction (a bf16 model's heads) decodes with the JAX package's
promotions (bbox3d_codec.py:43-70), where a value made of an integer bin
and Python floats is weakly typed: it takes bf16 where it meets the bf16
predictions, and a Python constant is rounded to bf16 before its bf16
operation. So the fine x and z offsets (the RCNN's) and the heading are
bf16 sums, each operation rounded; the y position is float32 (the base
points are); the sizes are bf16 (the anchor is); the box is float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...parallel.mesh import sum_over_ranks


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


def remainder(x: torch.Tensor, y) -> torch.Tensor:
    """x mod y (a number or a 0-dim tensor) with the sign of y, computed as
    jnp.remainder does: the truncated remainder, plus y where its sign
    differs from y's."""
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
    low = pred.dtype == torch.bfloat16

    def weak(v):
        # a float32 value of bins and Python floats meeting the predictions
        return v.to(pred.dtype) if low else v

    def const(c):
        # a Python constant of an operation on the predictions (filled on
        # their device: no copy from the host)
        return pred.new_full((), c) if low else c

    x_bin = torch.argmax(pred[:, 0:nbin], dim=1)  # the first of equal maxima
    z_bin = torch.argmax(pred[:, nbin:nbin * 2], dim=1)
    pos_x = x_bin * cfg.loc_bin_size + cfg.loc_bin_size / 2 - cfg.loc_scope
    pos_z = z_bin * cfg.loc_bin_size + cfg.loc_bin_size / 2 - cfg.loc_scope
    off = nbin * 2
    if cfg.xz_fine:
        size = const(cfg.loc_bin_size)
        pos_x = weak(pos_x) + _pick(pred[:, off:off + nbin], x_bin) * size
        pos_z = weak(pos_z) + _pick(pred[:, off + nbin:off + 2 * nbin], z_bin) * size
        off += 2 * nbin
    pos_y = base_xyz[:, 1] + pred[:, off]
    off += 1
    nh = cfg.num_head_bin
    ry_bin = torch.argmax(pred[:, off:off + nh], dim=1)
    ry_res = _pick(pred[:, off + nh:off + 2 * nh], ry_bin)
    if cfg.ry_fine:
        per = (math.pi / 2) / nh
        ry = weak(ry_bin * per + per / 2) + ry_res * const(per / 2) - const(math.pi / 4)
    else:
        per = (2 * math.pi) / nh
        ry = remainder(weak(ry_bin * per) + ry_res * const(per / 2), const(2 * math.pi))
        ry = torch.where(ry > const(math.pi), ry - const(2 * math.pi), ry)
    off += 2 * nh
    hwl = pred[:, off:off + 3] * anchor_size + anchor_size
    x, z = pos_x, pos_z
    if base_ry is not None:
        c, s = torch.cos(-base_ry), torch.sin(-base_ry)
        x, z = pos_x * c - pos_z * s, pos_x * s + pos_z * c
        ry = ry + base_ry
    return torch.cat([(x + base_xyz[:, 0])[:, None], pos_y[:, None],
                      (z + base_xyz[:, 2])[:, None], hwl, ry[:, None]], dim=-1)


def _sl1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """log-softmax over the last axis: F.log_softmax, or on bf16 logits
    jax.nn.log_softmax's operations, each rounded to bf16 (x - max, exp,
    the sum accumulated in float32, log, the difference), differentiated
    through them as JAX differentiates them."""
    if x.dtype != torch.bfloat16:
        return F.log_softmax(x, dim=-1)
    shifted = x - x.amax(dim=-1, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def reg_loss(pred: torch.Tensor, reg_label: torch.Tensor, mask: torch.Tensor,
             anchor_size: torch.Tensor,
             cfg: CodecCfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pred (N, C), reg_label (N, 7) [dx, dy, dz, h, w, l, ry], mask (N,)
    weights -> the masked means (loc, angle, size): cross-entropy over the
    x/z and heading bins, smooth-L1 on the residuals, the y offset and the
    anchor-normalized size (loss_utils.get_reg_loss:100-273)."""
    nbin = cfg.per_loc_bin_num
    m = mask.to(pred.dtype)
    denom = sum_over_ranks(m.sum()).clamp_min(1.0)

    def ce(logits, label):
        return -torch.gather(log_softmax(logits), 1, label[:, None])[:, 0]

    def mean(x):
        return (x * m).sum() / denom

    x_shift = (reg_label[:, 0] + cfg.loc_scope).clamp(0, cfg.loc_scope * 2 - 1e-3)
    z_shift = (reg_label[:, 2] + cfg.loc_scope).clamp(0, cfg.loc_scope * 2 - 1e-3)
    x_bin = torch.floor(x_shift / cfg.loc_bin_size).long()
    z_bin = torch.floor(z_shift / cfg.loc_bin_size).long()
    loc = mean(ce(pred[:, 0:nbin], x_bin)) + mean(ce(pred[:, nbin:2 * nbin], z_bin))
    off = 2 * nbin
    if cfg.xz_fine:
        half = cfg.loc_bin_size / 2
        xr_lbl = (x_shift - (x_bin * cfg.loc_bin_size + half)) / cfg.loc_bin_size
        zr_lbl = (z_shift - (z_bin * cfg.loc_bin_size + half)) / cfg.loc_bin_size
        loc = loc + mean(_sl1(_pick(pred[:, off:off + nbin], x_bin) - xr_lbl))
        loc = loc + mean(_sl1(_pick(pred[:, off + nbin:off + 2 * nbin], z_bin) - zr_lbl))
        off += 2 * nbin
    loc = loc + mean(_sl1(pred[:, off] - reg_label[:, 1]))
    off += 1

    nh = cfg.num_head_bin
    ry_label = reg_label[:, 6]
    if cfg.ry_fine:
        per = (math.pi / 2) / nh
        ry2 = remainder(ry_label, 2 * math.pi)
        opposite = (ry2 > math.pi * 0.5) & (ry2 < math.pi * 1.5)
        ry2 = torch.where(opposite, remainder(ry2 + math.pi, 2 * math.pi), ry2)
        shift = remainder(ry2 + math.pi * 0.5, 2 * math.pi)
        shift = (shift - math.pi * 0.25).clamp(1e-3, math.pi * 0.5 - 1e-3)
    else:
        per = (2 * math.pi) / nh
        shift = remainder(remainder(ry_label, 2 * math.pi) + per / 2, 2 * math.pi)
    ry_bin = torch.floor(shift / per).long()
    ry_res_lbl = (shift - (ry_bin * per + per / 2)) / (per / 2)
    angle = mean(ce(pred[:, off:off + nh], ry_bin))
    angle = angle + mean(_sl1(_pick(pred[:, off + nh:off + 2 * nh], ry_bin) - ry_res_lbl))
    off += 2 * nh

    size_lbl = (reg_label[:, 3:6] - anchor_size) / anchor_size
    size = (_sl1(pred[:, off:off + 3] - size_lbl) * m[:, None]).sum() / denom
    return loc, angle, size
