"""2D box delta codecs, 4- and 6-parameter stereo forms (counterpart of
disprcnn_tpu/models/rpn/box_coder.py; reference modeling/box_coder.py).

A stereo box is (x1, y1, x2, y2, x1', x2'): the right view shares y1/y2
with the left. Widths use the legacy +1 convention and log-space deltas are
clipped at log(1000/16) when decoded. The decode keeps the reference's
quirk of NOT subtracting 1 from x2/y2. ``encode6`` takes (N, 4) anchors
(the right pair encoded against the left geometry) or (N, 6) stereo
proposals (against the right pair's own).
"""
from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def _geom(b: torch.Tensor):
    w = b[..., 2] - b[..., 0] + 1.0
    h = b[..., 3] - b[..., 1] + 1.0
    return w, h, b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h


def _geom_p(b: torch.Tensor):  # the right pair (x1', x2'), columns 4:6
    w = b[..., 5] - b[..., 4] + 1.0
    return w, b[..., 4] + 0.5 * w


def encode4(ref: torch.Tensor, prop: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)):
    """(N, 4) reference boxes against (N, 4) proposals -> (N, 4) deltas."""
    wx, wy, ww, wh = weights
    ew, eh, ecx, ecy = _geom(prop)
    gw, gh, gcx, gcy = _geom(ref)
    return torch.stack([wx * (gcx - ecx) / ew, wy * (gcy - ecy) / eh,
                        ww * torch.log(gw / ew), wh * torch.log(gh / eh)], dim=-1)


def encode6(ref6: torch.Tensor, prop: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)):
    """(N, 6) stereo references against (N, 4) anchors or (N, 6) stereo
    proposals -> (N, 6) deltas."""
    wx, wy, ww, wh = weights
    base = encode4(ref6[..., :4], prop[..., :4], weights)
    gwp, gcxp = _geom_p(ref6)
    if prop.shape[-1] == 6:
        ewp, ecxp = _geom_p(prop)
    else:
        ewp, _, ecxp, _ = _geom(prop)
    return torch.cat([base, torch.stack([wx * (gcxp - ecxp) / ewp,
                                         ww * torch.log(gwp / ewp)], dim=-1)], dim=-1)


def decode4(deltas: torch.Tensor, boxes: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)):
    """(N, 4*K) deltas vs (N, 4) boxes -> (N, 4*K) xyxy."""
    wx, wy, ww, wh = weights
    w, h, cx, cy = _geom(boxes)
    shape = deltas.shape
    d = deltas.reshape(*shape[:-1], -1, 4)
    dx, dy = d[..., 0] / wx, d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp_max(BBOX_XFORM_CLIP)
    dh = (d[..., 3] / wh).clamp_max(BBOX_XFORM_CLIP)
    pcx = dx * w[..., None] + cx[..., None]
    pcy = dy * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
    return out.reshape(shape)


def decode6(deltas: torch.Tensor, boxes: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)):
    """(N, 6*K) deltas vs (N, 4) anchors -> (N, 6*K) stereo boxes; the right
    pair decodes against the left geometry."""
    wx, wy, ww, wh = weights
    w, h, cx, cy = _geom(boxes)
    shape = deltas.shape
    d = deltas.reshape(*shape[:-1], -1, 6)
    dx, dy = d[..., 0] / wx, d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp_max(BBOX_XFORM_CLIP)
    dh = (d[..., 3] / wh).clamp_max(BBOX_XFORM_CLIP)
    dxp = d[..., 4] / wx
    dwp = (d[..., 5] / ww).clamp_max(BBOX_XFORM_CLIP)
    pcx = dx * w[..., None] + cx[..., None]
    pcy = dy * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]
    pcxp = dxp * w[..., None] + cx[..., None]
    pwp = torch.exp(dwp) * w[..., None]
    out = torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph,
         pcxp - 0.5 * pwp, pcxp + 0.5 * pwp],
        dim=-1,
    )
    return out.reshape(shape)


def split_stereo(box6: torch.Tensor):
    """(..., 6) -> left (..., 4), right (..., 4) with shared y."""
    left = box6[..., 0:4]
    right = torch.stack([box6[..., 4], box6[..., 1], box6[..., 5], box6[..., 3]], dim=-1)
    return left, right


def join_stereo(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """left (..., 4) and right (..., 4) -> (..., 6), keeping the left y."""
    return torch.cat([left, right[..., 0:1], right[..., 2:3]], dim=-1)
