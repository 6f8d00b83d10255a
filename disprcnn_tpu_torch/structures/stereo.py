"""Paired left/right boxes with one score and validity (counterpart of
disprcnn_tpu/structures/stereo.py). Leading axes are free: (P, ...) for one
image or (B, P, ...) for a batch."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch

from .boxes import union_box


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., P, *rest) at idx (..., K) along P -> (..., K, *rest)."""
    lead = idx.dim() - 1
    rest = x.shape[lead + 1:]
    full = idx.reshape(*idx.shape, *(1,) * len(rest)).expand(*idx.shape, *rest)
    return torch.gather(x, lead, full)


@dataclass
class StereoBoxes:
    left: torch.Tensor  # (..., P, 4) xyxy
    right: torch.Tensor  # (..., P, 4) xyxy
    score: torch.Tensor  # (..., P)
    valid: torch.Tensor  # (..., P) bool
    fields: Dict[str, torch.Tensor] = field(default_factory=dict)

    def union(self) -> torch.Tensor:
        """(..., P, 4): the box that holds both views."""
        return union_box(self.left, self.right)

    def take(self, idx: torch.Tensor, idx_valid: torch.Tensor) -> "StereoBoxes":
        """The rows at idx (..., K), valid where both the row and idx_valid
        are."""
        return StereoBoxes(left=_take_rows(self.left, idx), right=_take_rows(self.right, idx),
                           score=_take_rows(self.score, idx),
                           valid=_take_rows(self.valid, idx) & idx_valid,
                           fields={k: _take_rows(v, idx) for k, v in self.fields.items()})
