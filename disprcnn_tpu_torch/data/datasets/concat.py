"""Dataset composition containers (a copy of
disprcnn_tpu/data/datasets/concat.py).

Reference: data/datasets/concat_dataset.py (bisect-based ConcatDataset) and
data/datasets/list_dataset.py (in-memory list of (image, target) pairs).
Samples here are plain dicts, so composition is index arithmetic.
"""
from __future__ import annotations

import bisect
from typing import List, Sequence


class ConcatDataset:
    """Concatenation of several sample-dict datasets (reference
    concat_dataset.py:9-44, including get_idxs cumulative bisect)."""

    def __init__(self, datasets: Sequence):
        assert datasets, "ConcatDataset needs at least one dataset"
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def get_idxs(self, idx: int):
        """-> (dataset_idx, sample_idx)."""
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else idx - self.cumulative_sizes[dataset_idx - 1]
        return dataset_idx, sample_idx

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        di, si = self.get_idxs(idx)
        return self.datasets[di][si]


class ListDataset:
    """Fixed in-memory list of samples (reference list_dataset.py)."""

    def __init__(self, samples: List[dict], transforms=None):
        self.samples = list(samples)
        self.transforms = transforms

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        s = self.samples[idx]
        if self.transforms is not None:
            s = self.transforms(s)
        return s
