"""PointNet++ primitives in plain PyTorch: FPS, ball query, grouping and
3-NN interpolation (counterpart of disprcnn_tpu/ops/points.py), with the
selection rules of the reference's pointnet2 CUDA extension:

- FPS starts at index 0 and takes the argmax of the running minimum
  distance, ties to the lowest index (ops/cuda/fps.py, which also holds its
  kernel);
- ball query scans points in index order and keeps the first `nsample`
  strictly within the radius; a partial ball repeats its first neighbour,
  an empty ball gives index 0;
- three-NN takes the 3 smallest squared distances, ties to the lowest
  index, with inverse-distance weights.

Points are channel-last (B, N, 3), features (B, N, C). Squared distances
come from ``sqdist``: direct differences summed x, y, z in that order.
Indices are int64.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cuda.fps import furthest_point_sample, sqdist

__all__ = ["ball_query", "first_k_true", "fps_or_identity", "furthest_point_sample",
           "gather_points", "group_points", "sqdist", "three_interpolate", "three_nn",
           "three_nn_interpolate_weights"]


def fps_or_identity(xyz: torch.Tensor, npoint: int) -> Optional[torch.Tensor]:
    """None when npoint >= N (FPS of every point is a permutation, and every
    consumer is order-invariant), else the FPS indices."""
    if npoint >= xyz.shape[1]:
        return None
    return furthest_point_sample(xyz, npoint)


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M) -> (B, M, C) rows."""
    return torch.gather(feats, 1, idx[..., None].expand(-1, -1, feats.shape[-1]))


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, S) -> (B, M, S, C), a row gather."""
    b, m, s = idx.shape
    return gather_points(feats, idx.reshape(b, m * s)).reshape(b, m, s, feats.shape[-1])


def first_k_true(mask: torch.Tensor, k: int):
    """Indices of the first k True entries of each row of (R, N) in scan
    order, and their count min(#True, k). Slots past the count hold
    indices of False entries (callers overwrite them)."""
    n = mask.shape[-1]
    iota = torch.arange(n, device=mask.device)
    key = torch.where(mask, iota, iota + n)
    idx = torch.sort(key, dim=-1, stable=True).indices[..., :k]
    if idx.shape[-1] < k:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (k - idx.shape[-1],))], -1)
    return idx, mask.sum(-1).clamp_max(k)


def ball_query(new_xyz: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """(B, M, 3) centres, (B, N, 3) points -> (B, M, nsample) int64: the
    first nsample points with squared distance < radius^2 in index order;
    a partial ball repeats its first neighbour, an empty one gives 0."""
    b, m = new_xyz.shape[:2]
    n = xyz.shape[1]
    d2 = sqdist(new_xyz[:, :, None, :], xyz[:, None, :, :])  # (B, M, N)
    mask = (d2 < radius * radius).reshape(b * m, n)
    cand, cnt = first_k_true(mask, nsample)
    slot = torch.arange(nsample, device=xyz.device)
    out = torch.where(slot[None, :] < cnt[:, None], cand, cand[:, :1])
    out = torch.where(cnt[:, None] > 0, out, torch.zeros_like(out))
    return out.reshape(b, m, nsample)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest `known` points of each `unknown` point: (B, N, 3), (B, M, 3)
    -> dists (B, N, 3) (Euclidean), idx (B, N, 3) int64; three rounds of
    argmin (the first of equal minima), each taking its column out."""
    d2 = sqdist(unknown[:, :, None, :], known[:, None, :, :])  # (B, N, M)
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1)  # the first of equal minima
        d = torch.gather(d2, -1, i[..., None])[..., 0]
        dists.append(d)
        idxs.append(i)
        d2 = d2.scatter(-1, i[..., None], float("inf"))
    return (torch.sqrt(torch.clamp_min(torch.stack(dists, -1), 0.0)),
            torch.stack(idxs, -1))


def three_nn_interpolate_weights(dists: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights, normalized over the 3 neighbours."""
    recip = 1.0 / (dists + eps)
    return recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3])


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """feats (B, M, C), idx and weight (B, N, 3) -> (B, N, C), summed over
    the neighbours in order."""
    g = group_points(feats, idx)  # (B, N, 3, C)
    w = weight[..., None]
    return (g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1]) + g[:, :, 2] * w[:, :, 2]
